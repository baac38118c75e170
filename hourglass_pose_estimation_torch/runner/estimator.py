"""Estimator: single-frame and batched inference from a config.

Port of `hourglass_pose_estimation_tpu/runner/estimator.py`: build the
model from the config, load its weights, preprocess BGR uint8 frames
(/255, per-dataset mean/std, resize to the network input), forward, take
the last stack's heatmaps and decode them into frame pixels. Two
preprocesses: the reference's host one (normalize, then cv2.resize each
frame; cv2 is imported only there) and the device one (raw uint8 frames
to the device, resize then normalize there: the same map up to f32
rounding, as bilinear weights sum to 1). On the card the forward runs the
fused bottleneck, upsample+add and pool kernels and the corrected decode
the decode kernel.
"""

from __future__ import annotations

import time
from collections.abc import Mapping

import numpy as np
import torch

from hourglass_pose_estimation_torch._device import resolve_device
from hourglass_pose_estimation_torch.config import Config
from hourglass_pose_estimation_torch.data import N_JOINTS
from hourglass_pose_estimation_torch.data.meanstd import ESTIMATOR_MEANSTD, get_meanstd
from hourglass_pose_estimation_torch.models import get_model
from hourglass_pose_estimation_torch.ops.decode import (
    decode_nms_peaks, decode_quarter_offset, decode_simple_argmax)
from hourglass_pose_estimation_torch.ops.resize import resize_bilinear_halfpix
from hourglass_pose_estimation_torch.runner import checkpoint as ckpt_lib
from hourglass_pose_estimation_torch.weights import load_jax_variables


class Estimator:
    @staticmethod
    def _joints_for(dataset: str) -> int:
        """Joint count from the inference config's dataset name: a dataset
        name, or the reference's loose substrings ('coco' -> 17, ...)."""
        if dataset in N_JOINTS:
            return N_JOINTS[dataset]
        # substrings only for a non-empty name ('' would match every key)
        if dataset:
            for key, n in N_JOINTS.items():
                if key in dataset or dataset in key:
                    return n
        raise ValueError(f'cannot derive num_classes from dataset {dataset!r}; '
                         'set MODEL.num_classes explicitly')

    def __init__(self, cfg: Config, variables=None,
                 strict_reference_stats: bool = False, device='cuda'):
        """variables: a JAX {'params', 'batch_stats'} tree or a port
        `state_dict`; None reads the checkpoint COMMON.resume names.
        strict_reference_stats: the reference estimator's hard-coded
        mean/std where it has them. Runs on `device` (the card unless
        device='cpu' is asked for)."""
        mc, cc = cfg.model, cfg.common
        self.cfg = cfg
        self.device = resolve_device(device)
        # num_classes: MODEL.num_classes, else len(MODEL.subset), else the
        # dataset's joint count
        num_classes = (mc.num_classes or (len(mc.subset) if mc.subset else 0)
                       or self._joints_for(cc.dataset))
        self.model = get_model(mc.arch, device=self.device, num_stacks=mc.num_stacks,
                               num_blocks=mc.num_blocks, num_classes=num_classes,
                               mobile=mc.mobile, skip_mode=mc.skip_mode,
                               out_res=cc.out_res, up_channel_num=mc.up_channel_num,
                               fuse_block=mc.fuse_block, fuse_upsample=mc.fuse_block)
        self.input_size = (cc.in_res, cc.in_res)
        self.threshold = 0.02
        self.mean, self.std = get_meanstd(cc.dataset)
        if strict_reference_stats:
            for key, v in ESTIMATOR_MEANSTD.items():
                if key in cc.dataset:
                    self.mean, self.std = v
                    break

        if variables is None:
            if not cc.resume:
                raise FileNotFoundError('Checkpoint not found')
            variables = ckpt_lib.restore_params(cc.resume, device=self.device)
        if isinstance(variables, Mapping) and 'params' in variables:
            load_jax_variables(self.model, variables)
        else:
            self.model.load_state_dict(variables, strict=True)
        self.model.eval()
        self._mean = torch.tensor(self.mean, dtype=torch.float32, device=self.device)
        self._std = torch.tensor(self.std, dtype=torch.float32, device=self.device)

    # -- preprocessing --------------------------------------------------
    def preprocess(self, frames: np.ndarray) -> torch.Tensor:
        """[B, H, W, 3] (or [H, W, 3]) BGR uint8 -> normalized, resized
        f32 [B, in_res, in_res, 3] on the device. The reference's order:
        normalize at the source resolution, then cv2.resize."""
        import cv2
        if frames.ndim == 3:
            frames = frames[None]
        mean = np.asarray(self.mean, np.float32)
        std = np.asarray(self.std, np.float32)
        x = (frames.astype(np.float32) / 255.0 - mean) / std
        out = np.zeros((frames.shape[0], *self.input_size, 3), np.float32)
        for i in range(len(x)):                 # cv2.resize is per-image
            out[i] = cv2.resize(x[i], self.input_size)
        return torch.from_numpy(out).to(self.device)

    @torch.inference_mode()
    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x, train=False)[-1]

    @torch.inference_mode()
    def _forward_raw(self, frames_u8: torch.Tensor) -> torch.Tensor:
        """Raw uint8 frames on the device -> heatmaps: /255, the half-pixel
        bilinear resize and the normalisation run there."""
        x = frames_u8.to(torch.float32) / 255.0
        x = resize_bilinear_halfpix(x, self.input_size)
        return self._forward((x - self._mean) / self._std)

    def _stage(self, frames: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)

    def _heatmaps(self, frames: np.ndarray, device_preprocess: bool) -> torch.Tensor:
        """frames [B|_, H, W, 3] uint8 -> last-stack heatmaps [B, h, w, J]
        on the device."""
        if frames.ndim == 3:
            frames = frames[None]
        if device_preprocess:
            return self._forward_raw(self._stage(frames))
        return self._forward(self.preprocess(frames))

    # -- decoding -------------------------------------------------------
    def post_process_v1(self, heatmaps, output_size):
        """Thresholded argmax with the x4 stride (the reference's
        estimator.py:56-74) -> (int32 [B, J, 2], maxvals [B, J]) numpy."""
        hms = torch.as_tensor(heatmaps, device=self.device)
        kps, maxv = decode_simple_argmax(hms, self.input_size, output_size, self.threshold)
        return kps.cpu().numpy(), maxv.cpu().numpy()

    def post_process_v2(self, heatmaps, output_size, strict_reference: bool = False):
        """Quarter-offset decode of heatmaps that cover the whole frame ->
        (int32 [B, J, 2] frame pixels, maxvals [B, J]) numpy.

        The reference (estimator.py:76-82) uses scale = out*4/200/hm_size,
        which maps a peak at (48, 20) of a 64^2 map over a 256^2 frame to
        (123, 121) instead of (192, 80): `strict_reference=True` keeps
        that, with its 1-based decode. The default treats the whole
        network input as the person box, decodes 0-based there (the decode
        kernel on the card) and stretches each axis to the frame, which
        need not be square."""
        hms = torch.as_tensor(heatmaps, device=self.device)
        B, H, W, J = hms.shape
        center = np.array([round(output_size[0] * 0.5), round(output_size[1] * 0.5)],
                          np.float32)
        if strict_reference:
            scale = np.array([output_size[0] * 4.0 / 200.0 / H,
                              output_size[1] * 4.0 / 200.0 / W], np.float32)
            kps, maxv = decode_quarter_offset(
                hms, np.tile(center, (B, 1)), np.tile(scale, (B, 1)),
                affine_size=(int(output_size[0]), int(output_size[1])))
            kps = kps.cpu().numpy()
        else:
            iw, ih = self.input_size
            centers = np.tile(np.array([iw / 2, ih / 2], np.float32), (B, 1))
            scales = np.tile(np.array([iw / 200.0, ih / 200.0], np.float32), (B, 1))
            kps, maxv = decode_quarter_offset(hms, centers, scales, zero_based=True)
            kps = kps.cpu().numpy() * np.array([output_size[0] / iw, output_size[1] / ih],
                                               np.float32)
        return kps.astype(np.int32), maxv.cpu().numpy()

    # -- inference ------------------------------------------------------
    def run(self, frame: np.ndarray, time_it: bool = True,
            device_preprocess: bool = False) -> np.ndarray:
        """One BGR uint8 frame [H, W, 3] -> [J, 2] int keypoints in frame
        pixels. The host cv2 preprocess by default (the reference's);
        device_preprocess=True runs it on the device. time_it prints the
        model's time, from the staged input to the heatmaps done on the
        device (the host preprocess not included, as in the reference)."""
        fh, fw = frame.shape[-3], frame.shape[-2]
        if frame.ndim == 3:
            frame = frame[None]
        if device_preprocess:
            staged = self._stage(frame)
            start = time.time()
            hms = self._forward_raw(staged)
        else:
            staged = self.preprocess(frame)
            start = time.time()
            hms = self._forward(staged)
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        if time_it:
            print(f'Inference time: {time.time() - start:.3f}s', flush=True)
        kps, _ = self.post_process_v2(hms, (fw, fh))
        return kps[0]

    def run_skeleton(self, frame: np.ndarray, device_preprocess: bool = False):
        """One frame -> ([J, 3] heatmap-space (x, y, conf) NMS peaks,
        heatmap (H, W)) for skeleton drawing (the reference's visualizer
        decode, `ops.decode.decode_nms_peaks`)."""
        hms = self._heatmaps(frame, device_preprocess)
        return decode_nms_peaks(hms)[0].cpu().numpy(), tuple(hms.shape[1:3])

    def run_batch(self, frames: np.ndarray, device_preprocess: bool = False) -> np.ndarray:
        """[B, H, W, 3] BGR uint8 -> [B, J, 2] int keypoints in frame
        pixels."""
        hms = self._heatmaps(frames, device_preprocess)
        kps, _ = self.post_process_v2(hms, (frames.shape[2], frames.shape[1]))
        return kps
