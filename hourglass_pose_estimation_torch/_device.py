"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device='cuda') -> torch.device:
    """torch.device for `device`; a CUDA device that is not there raises.

    The port runs on the card unless the caller asks for the CPU
    (device='cpu'), where every kernel wrapper takes its plain version.
    There is no silent fallback from one to the other."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'device {str(device)!r}: no CUDA device is '
                           "available; pass device='cpu' to run the plain "
                           'PyTorch path on the CPU')
    return dev
