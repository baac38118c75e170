#!/usr/bin/env python3
"""Experiment: the cost of adding a convolution's bias after its bf16
product, as flax does, against adding it inside the product.

    python3 experiments/conv_bias_rounding.py [--steps N] [--out FILE]

`models.modules.Conv` adds its bias to the product after the product is
rounded to the compute dtype (`after`, the module as it is), as flax's
`nn.Conv` does. `F.conv2d(x, w, b)` (`inside`, the module before) takes
the bias into the product's sum on the CPU, which leaves 30% of a bf16
conv's outputs one step from the JAX model's; on the card PyTorch's
convolution adds the bias in a pass of its own after the product, so
both forms do the same work there. This script measures what that
costs or saves on the card.

On one card, the flagship model (8 stacks, 1 block, 16 joints, 256^2,
bf16 compute, the kernels on) at batch 64: the train step of
`runner.train_state.make_train_step` on bench.py's synthetic batch, and
the eval forward (running-average BN, the fused bottleneck), each timed
under both Conv forwards in the order after, inside, inside, after
(median of N steps or forwards each, after 3 untimed ones). Prints the
card's name and power limit and one JSON line; writes it to --out.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

BATCH, RES = 64, 256


def inside(self, x):
    """The previous Conv forward: the bias inside the product."""
    import torch.nn.functional as F
    dt = self.compute_dtype
    return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                    self.stride, self.padding, 1, self.groups)


def median_ms(fn, n: int) -> float:
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument('--steps', type=int, default=10)
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print('needs a CUDA card', file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    from hourglass_pose_estimation_torch.data import Synthetic, make_spec
    from hourglass_pose_estimation_torch.models import get_model
    from hourglass_pose_estimation_torch.models.modules import Conv
    from hourglass_pose_estimation_torch.runner import (
        init_state, make_optimizer, make_train_step)
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    ds = Synthetic(True, num_samples=BATCH, inp_res=RES, out_res=RES // 4, sigma=1,
                   scale_factor=0.25, rot_factor=30)
    raw, spec = ds.canvas_batch(range(BATCH), canvas=RES), make_spec(ds)
    torch.manual_seed(0)
    model = get_model('hg', device='cuda', num_stacks=8, num_blocks=1, num_classes=16,
                      mobile=False, skip_mode='sum', fuse_block=True, fuse_upsample=True)
    state = init_state(model, make_optimizer(2.5e-3, [35, 45], 0.1, 100))
    step = make_train_step(spec, device_pipeline=True)
    x = torch.randn(BATCH, RES, RES, 3, device='cuda')
    after = Conv.forward
    box = {'state': state}

    def train():
        box['state'], m = step(box['state'], raw, 0)
        float(m['loss'])

    def forward():
        with torch.no_grad():
            box['state'].model(x, train=False)

    out = {'card': card, 'batch': BATCH, 'steps': args.steps}
    for what, fn in (('train_step_ms', train), ('eval_forward_ms', forward)):
        for variant in ('after', 'inside', 'inside', 'after'):
            Conv.forward = after if variant == 'after' else inside
            out.setdefault(what, {}).setdefault(variant, []).append(median_ms(fn, args.steps))
    Conv.forward = after
    for what in ('train_step_ms', 'eval_forward_ms'):
        t = out[what]
        out[what + '_after_over_inside'] = sum(t['after']) / sum(t['inside'])
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
