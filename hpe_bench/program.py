"""What the benchmark takes from the program (the `_torch` port): its model
built from a configuration file, with the benchmark's seeded weights.
Every entry builds the system under test here, so a configuration means
the same model in every cell."""

from __future__ import annotations

import torch

from hpe_bench import synth

DTYPES = {'bfloat16': torch.bfloat16, 'float32': torch.float32, 'float64': torch.float64}


def build_model(cfg: dict, seed: int, device):
    """The program's model of configuration `cfg` on `device`: `get_model`
    of its `arch`, with its `num_stacks`, `num_classes`, `compute_dtype`
    and the keyword arguments under its `model`; its parameters and
    BatchNorm statistics the seeded ones (`synth.weights`). -> (model, the
    seeded tensors by name)."""
    from hourglass_pose_estimation_torch.models import get_model
    dev = torch.device(device)
    with dev:
        model = get_model(cfg['arch'], device=dev, num_stacks=cfg['num_stacks'],
                          num_classes=cfg['num_classes'], dtype=DTYPES[cfg['compute_dtype']],
                          **cfg['model'])
    sd = model.state_dict()
    w = synth.weights({k: tuple(v.shape) for k, v in sd.items()}, seed, dev,
                      cfg.get('bn_scale_of'))
    with torch.no_grad():
        for k, v in sd.items():
            v.copy_(w[k])
    return model, w


def sync(device) -> None:
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    return torch.cuda.max_memory_allocated(device) if torch.device(device).type == 'cuda' else 0


def reset_peak(device) -> None:
    if torch.device(device).type == 'cuda':
        torch.cuda.reset_peak_memory_stats(device)
