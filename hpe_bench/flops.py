"""Model FLOPs from convolution shapes: the reference model's forward at a
configuration's input size, traced on the meta device (no data, no
memory), with `torch.utils.flop_counter` counting 2 * multiply-adds of
each convolution. A train step counts three forwards' worth (the forward,
and the backward's two products a convolution), as MFU is usually
counted; recomputation is not counted.
"""

from __future__ import annotations

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode


@functools.lru_cache(maxsize=None)
def _conv_flops(cfg_json: str) -> int:
    from hpe_bench.reference.train import build
    cfg = json.loads(cfg_json)
    with torch.device('meta'):
        model = build(cfg, 'meta')
        x = torch.empty((1, cfg['inp_res'], cfg['inp_res'], 3))
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(x, train=False)
    return int(sum(v for k, v in counter.get_flop_counts()['Global'].items()
                   if 'convolution' in str(k)))


def forward_flops(cfg: dict) -> int:
    """Convolution FLOPs of one image's forward under configuration `cfg`."""
    return _conv_flops(json.dumps(cfg, sort_keys=True))


def train_flops(cfg: dict) -> int:
    """FLOPs of one image's train step: three forwards' worth."""
    return 3 * forward_flops(cfg)
