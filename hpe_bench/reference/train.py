"""The reference's first train steps, and the numbers a train cell compares.

`first_steps` follows the program's first steps from the same seeded
weights on the same raw batches with the same draws, in f32 (or, as the
control, with fp8 convolutions; or, for `calibrate.py`'s witnesses, in
bf16 or f64), and returns what the comparison reads:
each step's loss, each leaf's gradient norm at step 1, and each leaf's
change after the steps.

`compare` turns the program's readings and the reference's into the
cell's numbers. A leaf's gap is the gap between the program's norm and the
reference's, |n - n_ref|, over the larger of the reference's norm of that
leaf and of the median leaf; only the leaves whose reference gradient is
at least a thousandth of the median leaf's count (a conv bias ahead of a
train-mode BatchNorm has a true gradient of 0, the program's bf16 sums
leave rounding noise there, and RMSprop moves it by that noise alone).
  * grad_gap: the median leaf's gap of the step-1 gradients' norms (the
    worst leaf is a BatchNorm scale or shift at the stem, summed over a
    million values a channel, whose bf16 noise matches fp8's: PERF.md);
  * grad_diff: the median leaf's norm of the difference of the step-1
    gradients, over the same denominator: a norm's gap is second order in
    noise that is not biased, this difference first order, and only it
    tells MSPN's bf16 from fp8 (PERF.md);
  * change_gap: the worst leaf's gap of the parameters' change after the
    steps.
`detail` adds what PERF.md reads them with: each step's loss gap
(after step 1, RMSprop's first update, lr * 10 * sign(g), turns rounding
into chaos), the worst leaves, the leaves left out.
"""

from __future__ import annotations

import statistics

import torch

from hpe_bench import harness
from hpe_bench.reference import pipeline
from hpe_bench.reference.layers import no_tf32, set_precision

MOVED_SHARE = 1e-3


def build(cfg: dict, device, checkpointed: bool = False):
    """The reference model of a configuration, on `device`, f32: the
    `build(cfg, checkpointed)` of the module file its `reference` names."""
    path = harness.ROOT / cfg['reference']
    module = harness.load_module(path, f'hpe_bench_reference_{path.stem}')
    return module.build(cfg, checkpointed=checkpointed).to(device)


def first_steps(cfg: dict, weights: dict, raws: list, seed: int, spec: dict, lr: float,
                precision: str = 'f32') -> dict:
    """Steps 1..len(raws) of the reference from `weights` (name -> tensor),
    raws[i] the batch of step i, its convolutions in `precision` (layers.
    PRECISIONS; 'f64' runs the whole step in float64).
    -> {'loss': [..], 'grad': {name: norm}, 'grad_vec': {name: gradient},
    'change': {name: norm}}."""
    no_tf32()
    dev = next(iter(weights.values())).device
    dt = torch.float64 if precision == 'f64' else torch.float32
    model = set_precision(build(cfg, dev, checkpointed=True), precision).to(dt)
    model.load_state_dict(weights, strict=True)
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    start = [p.detach().clone() for p in params]
    sq = [torch.zeros_like(p) for p in params]
    losses, grad, grad_vec = [], None, None
    for i, raw in enumerate(raws):
        d = pipeline.draws(seed, i, raw['scale'].float(), spec['scale_factor'], spec['rot_factor'])
        img, target, w = (t.to(dt) for t in pipeline.augment(raw, d, spec))
        loss = pipeline.loss_fn(model(img, train=True), target, w)
        gs = torch.autograd.grad(loss, params)
        losses.append(float(loss.detach()))
        if i == 0:
            grad_vec = {n: g.detach().clone() for n, g in zip(names, gs)}
            grad = {n: float(g.norm()) for n, g in grad_vec.items()}
        pipeline.rmsprop_(params, gs, sq, lr)
        del gs, loss, img, target, w
    change = {n: float((p.detach() - s).norm()) for n, p, s in zip(names, params, start)}
    return {'loss': losses, 'grad': grad, 'grad_vec': grad_vec, 'change': change}


def compare(prog: dict, ref: dict) -> dict:
    """The three numbers (see the module docstring) of the program's
    readings against the reference's (both as `first_steps` returns them)."""
    return {k: v for k, v in detail(prog, ref).items() if k in NUMBERS}


NUMBERS = ('grad_gap', 'grad_diff', 'change_gap')


def _gaps(prog: dict, ref: dict, names: list) -> dict:
    """Each leaf's |n - n_ref| over the larger of n_ref and the median leaf's."""
    med = statistics.median(ref[n] for n in names)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med) for n in names}


def detail(prog: dict, ref: dict) -> dict:
    """The compared numbers and what explains them: each step's loss gap,
    the worst leaves, the median leaf's gaps, the leaves left out."""
    steps = [abs(a - b) / abs(b) for a, b in zip(prog['loss'], ref['loss'])]
    med_g = statistics.median(ref['grad'].values())
    moved = [n for n, g in ref['grad'].items() if g >= MOVED_SHARE * med_g]
    g = _gaps(prog['grad'], ref['grad'], moved)
    c = _gaps(prog['change'], ref['change'], moved)
    g_all = _gaps(prog['grad'], ref['grad'], list(ref['grad']))
    med_n = statistics.median(ref['grad'][n] for n in moved)
    diff = {n: float((prog['grad_vec'][n].to(ref['grad_vec'][n].device) - ref['grad_vec'][n]).norm())
            / max(ref['grad'][n], med_n) for n in moved}
    worst = lambda d: max(d, key=d.get)
    return {'grad_gap': statistics.median(g.values()), 'grad_diff': statistics.median(diff.values()),
            'change_gap': max(c.values()), 'grad_diff_worst': max(diff.values()),
            'loss_gap_steps': steps, 'grad_gap_worst': max(g.values()), 'grad_worst': worst(g),
            'change_worst': worst(c), 'change_gap_median': statistics.median(c.values()),
            'grad_gap_all_leaves': max(g_all.values()), 'grad_worst_all': worst(g_all),
            'left_out': len(ref['grad']) - len(moved)}
