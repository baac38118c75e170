"""Model registry (string -> factory), as in the JAX package."""

from hourglass_pose_estimation_torch.models.hourglass import HourglassNet, hg
from hourglass_pose_estimation_torch.models.modules import (
    Bottleneck, Hourglass, ResidualChain)


def _mspn(**kwargs):
    raise NotImplementedError('arch=mspn comes with its own slice: ROADMAP '
                              'Queue 1 item 12')


REGISTRY = {
    'hg': hg,
    'mspn': _mspn,
}


def get_model(arch: str, device='cuda', **kwargs):
    """Build `arch` on `device` (CUDA unless device='cpu' is asked for)."""
    if arch not in REGISTRY:
        raise KeyError(f"unknown arch '{arch}'; available: {sorted(REGISTRY)}")
    return REGISTRY[arch](device=device, **kwargs)
