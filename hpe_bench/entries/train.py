"""Entry: the program's train step (`runner.make_train_step`, device
pipeline), one process, one card.

Set-up builds one train state from the seed (the configuration's model with
seeded weights, RMSprop) and a pool of seeded raw canvas batches, and
drives the state through the traffic's first steps with the window's own
call on the pool's first batches (their rows all differ). Those steps are
also what the reference follows: their losses, the step-1 gradients as
RMSprop's state holds them (E[g^2] = 0.01 g^2, and the sign of its first
update) and the parameters' change after the last of them are read before
the window moves the state on. The window then steps the same state, cycling through the pool with new
augmentation draws each step, for `--seconds`; the losses stay on the card
until the window has closed. A `--trace 1` run profiles a few more steps
after the window.
"""

from __future__ import annotations

import time

import torch

from hpe_bench import flops, program, synth
from hpe_bench.reference import train as reference


def spec_of(cfg: dict, mix: dict) -> dict:
    return {'inp_res': cfg['inp_res'], 'out_res': cfg['out_res'], 'sigma': mix['sigma'],
            'scale_factor': mix['scale_factor'], 'rot_factor': mix['rot_factor'],
            'flip_perm': flip_perm(cfg['num_classes']), 'mean': tuple(mix['mean']),
            'std': tuple(mix['std'])}


def flip_perm(J: int) -> tuple:
    perm = list(range(J))
    for a, b in synth.FLIP_PAIRS:
        if a < J and b < J:
            perm[a], perm[b] = b, a
    return tuple(perm)


def make_pool(cfg: dict, mix: dict, seed: int, device, batches: int, batch: int) -> list:
    """`batches` raw canvas batches of `batch` seeded figures each."""
    imgs, joints, vis = synth.figures(batches * batch, cfg['inp_res'],
                                      synth.generator(seed, 2, device), device,
                                      cfg['num_classes'])
    return [synth.canvas_batch(imgs[i * batch:(i + 1) * batch], joints[i * batch:(i + 1) * batch],
                               vis[i * batch:(i + 1) * batch]) for i in range(batches)]


def program_readings(state, start: dict, losses: list, grad: dict) -> dict:
    """What the comparison reads of the program after its first steps."""
    change = {n: float((p.detach().float() - start[n]).norm())
              for n, p in state.model.named_parameters()}
    return {'loss': [float(x) for x in losses], 'grad': {n: float(g.norm()) for n, g in grad.items()},
            'grad_vec': grad, 'change': change}


def first_grads(state, start: dict) -> dict:
    """Each leaf's step-1 gradient as the optimizer got it, from its state
    after one step (on the host): RMSprop's E[g^2] = (1 - alpha) g^2 gives
    |g|, and its first update, -lr g / (|g| sqrt(1 - alpha) + eps), the
    sign."""
    alpha = state.optimizer.param_groups[0]['alpha']
    out = {}
    for n, p in state.model.named_parameters():
        mag = (state.optimizer.state[p]['square_avg'].float() / (1.0 - alpha)).sqrt()
        out[n] = (torch.sign(start[n] - p.detach().float()) * mag).cpu()
    return out


def setup(r):
    """The train state after the traffic's first steps, and what the
    comparison reads of them."""
    from hourglass_pose_estimation_torch.data.pipeline import PipelineSpec
    from hourglass_pose_estimation_torch import runner
    cfg, mix = r.cell['cfg'], r.cell['mix']
    dev = torch.device(r.device)
    model, weights = program.build_model(cfg, r.seed, dev)
    pool = make_pool(cfg, mix, r.seed, dev, mix['pool_batches'], mix['batch'])
    spec = spec_of(cfg, mix)
    opt = mix['optimizer']
    state = runner.init_state(model, runner.make_optimizer(
        opt['lr'], opt['schedule'], opt['gamma'], opt['steps_per_epoch']))
    step = runner.make_train_step(PipelineSpec(**spec))
    start = {n: p.detach().float().clone() for n, p in model.named_parameters()}
    losses, grad = [], None
    for i in range(mix['first_steps']):
        state, m = step(state, pool[i % len(pool)], r.seed)
        losses.append(m['loss'])
        if i == 0:
            grad = first_grads(state, start)
    readings = program_readings(state, start, losses, grad)
    del start
    return state, step, pool, spec, weights, readings


def run(r) -> dict:
    cfg, mix = r.cell['cfg'], r.cell['mix']
    dev = torch.device(r.device)
    state, step, pool, spec, weights, readings = setup(r)
    n_first = mix['first_steps']
    program.sync(dev)
    setup_s = time.time() - r.t0
    peak = program.peak_bytes(dev)
    program.reset_peak(dev)

    B, n, losses = mix['batch'], 0, []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < r.seconds:
        state, m = step(state, pool[(n_first + n) % len(pool)], r.seed)
        losses.append(m['loss'])
        n += 1
    program.sync(dev)
    window_s = time.perf_counter() - t0
    window_peak = program.peak_bytes(dev)
    losses = torch.stack(losses).float().cpu()
    failed = int((~torch.isfinite(losses)).sum())

    summary = None
    if r.trace:
        from hpe_bench.trace import Window
        with Window(dev) as w:
            for k in range(mix['trace_steps']):
                state, _ = step(state, pool[k % len(pool)], r.seed)
        with Window(dev, ops=True) as w_ops:
            state, _ = step(state, pool[0], r.seed)
        summary = dict(w.summary, port=w_ops.summary['port'])
    memory = max(peak, window_peak, program.peak_bytes(dev))
    first = pool[:n_first]
    del state, step, pool[n_first:]
    if dev.type == 'cuda':
        torch.cuda.empty_cache()

    ref = reference.first_steps(cfg, weights, first, r.seed, spec, mix['optimizer']['lr'])
    numbers = reference.compare(readings, ref)
    images = n * B
    return {
        'setup_s': setup_s, 'attempted': n, 'failed': failed,
        'e2e': {'train_img_s': images / window_s},
        'numbers': numbers, 'memory_peak_bytes': memory, 'count': 1, 'trace': summary,
        'ctx': {'kind': 'train', 'images': images, 'steps': n, 'window_s': window_s,
                'train_flops_per_image': flops.train_flops(cfg), 'chips': 1,
                'window_peak_bytes': window_peak, 'out_hw': (cfg['out_res'], cfg['out_res'])},
    }
