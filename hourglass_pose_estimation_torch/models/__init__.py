"""Model registry (string -> factory), as in the JAX package, and the one
build from a config that the Trainer, the Estimator and `serve_http`
share."""

from hourglass_pose_estimation_torch.models.hourglass import HourglassNet, hg
from hourglass_pose_estimation_torch.models.modules import (
    Bottleneck, Hourglass, ResidualChain)
from hourglass_pose_estimation_torch.models.mspn import MSPN, mspn

REGISTRY = {
    'hg': hg,
    'mspn': mspn,
}


def get_model(arch: str, device='cuda', **kwargs):
    """Build `arch` on `device` (CUDA unless device='cpu' is asked for)."""
    if arch not in REGISTRY:
        raise KeyError(f"unknown arch '{arch}'; available: {sorted(REGISTRY)}")
    return REGISTRY[arch](device=device, **kwargs)


def model_from_config(mc, *, num_classes: int, out_res: int, device='cuda', **kwargs):
    """The model a `ModelConfig` describes, with `num_classes` joints and
    `out_res` heatmaps (each caller reads its own config key for it).
    MODEL.fuse_block, resolved per arch by the config (on for hg, off for
    mspn unless set), switches both of the hourglass's kernel routes; the
    MSPN factory raises on it. kwargs (dtype, remat, bn_stat_samples) go
    to the factory."""
    return get_model(mc.arch, device=device, num_stacks=mc.num_stacks,
                     num_blocks=mc.num_blocks, num_classes=num_classes,
                     mobile=mc.mobile, skip_mode=mc.skip_mode, out_res=out_res,
                     up_channel_num=mc.up_channel_num, fuse_block=mc.fuse_block,
                     fuse_upsample=mc.fuse_block, **kwargs)
