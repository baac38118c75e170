"""Typed, validated configuration (the port's own copy).

Parses the same YAML sections and keys as `hourglass_pose_estimation_tpu/
config.py` (DATASET / MODEL / TRAIN / COMMON / EVAL, `SECTION.key=value`
overrides), so one config file drives both packages: every key of the JAX
package, with its default and validation. Keys that ask for what the port
has not got yet (several devices, the host cv2 pipeline) parse here and
are refused, with the ROADMAP item that brings them, by the entry point
that would read them. One default differs: MODEL.fuse_block is the arch's
own, on for hg (off in the JAX package) and off for mspn and hrnet. One
key is the port's alone: MODEL.width, the width of arch=hrnet, a model the
JAX package does not have.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence

import yaml


def _coerce(value: str):
    """Best-effort literal coercion for CLI overrides."""
    try:
        return yaml.safe_load(value)
    except Exception:
        return value


@dataclass(frozen=True)
class DatasetConfig:
    name: str = 'synthetic'
    image_path: str = ''
    annotation_path: str = ''
    inp_res: int = 256
    out_res: int = 64
    flip: bool = True
    sigma: int = 1
    scale_factor: float = 0.25
    rot_factor: float = 30.0
    label_type: str = 'Gaussian'
    device_pipeline: bool = True   # augment + render targets on device
    num_samples: int = 512         # synthetic dataset size
    # device-pipeline canvas: side in px (0 -> max(inp_res, 64)) and
    # packing mode: 'crop' packs the person's reachable crop region at
    # native resolution where it fits (downscaled where it does not),
    # 'image' scales the whole source image into the canvas.
    canvas: int = 0
    canvas_mode: str = 'crop'

    def __post_init__(self):
        if self.label_type != 'Gaussian':
            raise ValueError('only Gaussian targets are supported '
                             '(parity: common.py:206-207)')
        if self.inp_res % self.out_res != 0:
            raise ValueError('inp_res must be a multiple of out_res')
        if self.canvas_mode not in ('crop', 'image'):
            raise ValueError("canvas_mode must be 'crop' or 'image'")


# MODEL.fuse_block where the config leaves it unset, per arch
_FUSE_BLOCK_DEFAULT = {'hg': True, 'mspn': False, 'hrnet': False}


@dataclass(frozen=True)
class ModelConfig:
    arch: str = 'hg'
    num_stacks: int = 2
    num_blocks: int = 1
    mobile: bool = False
    skip_mode: str = 'sum'
    num_classes: int = 0           # 0 -> derive from dataset / subset
    subset: Optional[List[int]] = None
    # MSPN decoder width. The reference factory overloads num_blocks for
    # this (mspn.py:310, so its Trainer silently builds width 1); here it
    # is explicit so reference MSPN checkpoints of any width import.
    # arch=hg rejects non-default values rather than ignore them.
    up_channel_num: int = 256
    # HRNet's finest branch width (W48: 48); the port's own key (the JAX
    # package has no HRNet), which only arch=hrnet reads
    width: int = 48
    # arch=hg only: the Hopper kernels on the serving path. Eligible
    # bottlenecks (identity residual, >= 16 px, running-average BN, and
    # the kernel's scope: bf16 compute, 128 planes) run the fused
    # bottleneck kernel (models/modules.py Bottleneck.fuse_block); an f32
    # model (TRAIN.precision f32) runs its standard blocks. Sum merges take
    # the fused upsample+add (Hourglass.fuse_upsample).
    # Unset, it takes the arch's own default (_FUSE_BLOCK_DEFAULT): on for
    # hg, unlike the JAX package (on the card both kernels beat their plain
    # versions, PERF.md, and CPU tensors take the plain versions anyway);
    # off for mspn, which has no such block and whose factory raises on a
    # true value, as the JAX one does. False runs the plain path, the
    # kernels-off control.
    fuse_block: Optional[bool] = None

    def __post_init__(self):
        if self.skip_mode not in ('sum', 'concat'):
            raise ValueError("skip_mode must be 'sum' or 'concat'")
        if self.fuse_block is None:
            object.__setattr__(self, 'fuse_block',
                               _FUSE_BLOCK_DEFAULT.get(self.arch, False))


@dataclass(frozen=True)
class TrainConfig:
    num_workers: int = 0
    epochs: int = 50
    start_epoch: int = 0
    train_batch: int = 32
    val_batch: int = 32
    learning_rate: float = 2.5e-3
    schedule: List[int] = field(default_factory=lambda: [35, 45])
    gamma: float = 0.1
    precision: str = 'bf16'
    data_parallel: int = 0         # 0 -> all devices
    model_parallel: int = 1
    steps_per_epoch: int = 0       # 0 -> full dataset
    # the explicit-collectives train step (several devices); sync_bn=False
    # keeps per-replica BatchNorm statistics there
    explicit_collectives: bool = False
    sync_bn: bool = True
    # per-hourglass rematerialization (activation memory <-> ~1/3 fwd FLOPs)
    remat: bool = False
    # pipeline parallelism over hourglass stacks: size of the 'pipe' axis
    # (1 = off) and microbatches per step
    pipeline_parallel: int = 1
    microbatches: int = 2
    # BN batch statistics from the first k samples only (0 = full batch)
    bn_stat_samples: int = 0
    # freeze BatchNorm from this epoch on (0 = never): the train forward
    # switches to running-average statistics (and so to the fused
    # bottleneck) and the statistics stop moving
    freeze_bn_after_epoch: int = 0

    def __post_init__(self):
        if self.precision not in ('bf16', 'f32'):
            raise ValueError("precision must be 'bf16' or 'f32'")
        if self.explicit_collectives and self.model_parallel > 1:
            raise ValueError('explicit_collectives requires model_parallel=1')


@dataclass(frozen=True)
class EvalConfig:
    decode: str = 'quarter'        # 'quarter' | 'dark'
    flip_test: bool = False
    official: bool = False         # dataset-official metrics (PCKh / OKS)
    gt_mat: str = ''               # MPII gt_<set>.mat for PCKh
    # export surface (scripts/export.py): fuse the keypoint decode into
    # the artifact (frames -> keypoints) and fold BN constants
    export_keypoints: bool = False
    export_fold_bn: bool = True
    # bake /255 -> resize -> mean/std normalize into the artifact: the
    # exported function then consumes RAW uint8 frames (camera bytes)
    export_preprocess: bool = False
    # static batch of the exported program (a serving front-end pads
    # partial batches to this — tools/serve_http.py); bf16 conv kernels
    # halve weight HBM traffic (keypoints stay ~1e-2 px of f32, tested)
    export_batch: int = 1
    export_bf16_weights: bool = False

    def __post_init__(self):
        if self.decode not in ('quarter', 'dark'):
            raise ValueError("decode must be 'quarter' or 'dark'")
        if self.export_batch < 1:
            raise ValueError('export_batch must be >= 1')


@dataclass(frozen=True)
class CommonConfig:
    checkpoint_dir: str = './checkpoints'
    snapshot: int = 10
    resume: str = ''
    evaluate_only: bool = False
    pck: float = 0.5
    seed: int = 0
    summary: bool = False      # print a model summary at build
    # inference-only keys (estimate.py surface)
    image_path: str = ''
    dest_path: str = ''
    dataset: str = ''
    in_res: int = 256
    out_res: int = 64
    # NMS peak decode + skeleton-line rendering instead of circles
    skeleton: bool = False
    # fuse /255 + resize + normalize into the device forward (raw uint8 in)
    device_preprocess: bool = False


@dataclass(frozen=True)
class Config:
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    common: CommonConfig = field(default_factory=CommonConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)

    def run_name(self) -> str:
        """Checkpoint-dir naming parity (train_and_evaluate.py:7-15)."""
        subset = 'all' if self.model.subset is None else str(self.model.subset)
        mobile = 'mobile' if self.model.mobile else 'non-mobile'
        return (f'{self.dataset.name}_{self.model.arch}_'
                f's{self.model.num_stacks}_{mobile}_{subset}')


_SECTION_MAP = {
    'DATASET': ('dataset', DatasetConfig),
    'MODEL': ('model', ModelConfig),
    'TRAIN': ('train', TrainConfig),
    'COMMON': ('common', CommonConfig),
    'EVAL': ('eval', EvalConfig),
}


def _build_section(cls, raw: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    known = {k: v for k, v in raw.items() if k in names}
    unknown = set(raw) - names
    if unknown:
        # the reference tolerates dead keys (e.g. DATASET.flip) — warn, keep going
        import warnings
        warnings.warn(f'{cls.__name__}: ignoring unknown keys {sorted(unknown)}')
    return cls(**known)


def load_config(path: Optional[str] = None,
                overrides: Sequence[str] = (),
                raw: Optional[dict] = None) -> Config:
    """Load a YAML config (reference-compatible schema) with overrides.

    Overrides are `SECTION.key=value` strings, e.g.
    `TRAIN.train_batch=64 MODEL.num_stacks=8`.
    """
    data: dict = {}
    if path:
        if not os.path.isfile(path):
            raise FileNotFoundError(path)
        with open(path) as fp:
            data = yaml.safe_load(fp) or {}
    if raw:
        data = {**data, **raw}

    for ov in overrides:
        if '=' not in ov or '.' not in ov.split('=', 1)[0]:
            raise ValueError(f'override must be SECTION.key=value, got {ov!r}')
        key, value = ov.split('=', 1)
        section, name = key.split('.', 1)
        section = section.upper()
        # an empty YAML section ('TRAIN:' with no keys) parses to None —
        # setdefault would return it and crash the item assignment
        if data.get(section) is None:
            data[section] = {}
        data[section][name] = _coerce(value)

    # unknown top-level sections — typos ('TRIAN') and lowercase
    # ('train:') included — must warn like unknown keys do, not be
    # silently dropped (a dropped TRAIN section runs with all defaults)
    import warnings
    for section in data:
        if section not in _SECTION_MAP:
            hint = (f" (did you mean '{section.upper()}'?)"
                    if section.upper() in _SECTION_MAP else '')
            warnings.warn(f'ignoring unknown config section '
                          f'{section!r}{hint}')

    kwargs = {}
    for section, (attr, cls) in _SECTION_MAP.items():
        kwargs[attr] = _build_section(cls, data.get(section, {}) or {})
    return Config(**kwargs)
