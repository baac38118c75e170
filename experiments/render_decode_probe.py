#!/usr/bin/env python3
"""Experiment: the render and decode kernels on the device alone.

    python3 experiments/render_decode_probe.py [--out FILE]

Builds the package's kernels, the first-generation ones
(`experiments/render_decode_v1.cu`) and the variants
(`experiments/render_decode_variants.cu`), one nvcc per source, all
started together, and times each on one card with `chip_smoke.py`'s
method: one call's device time from a CUDA graph of 20 calls, `cold`
(each call on its own inputs and output) and `hot` (one set of inputs),
the median of 5 replays. Versions of one function are timed in turns
(v1, present, variants, then the reverse) and every output is held
equal to v1's (the render within 1 ulp, decode exactly, NaN where v1
has NaN).

  render  [64, 64^2, 16] f32 at sigma 1, joints as chip_smoke plants
          them: v1, the present kernel (st.global.cs.v4 from registers)
          and its TMA-store variant; beside them the floor of a kernel
          that only writes the same bytes (`hpe_fill_zero_cs`, float4
          evict-first stores) and `Tensor.zero_()`;
  decode  [B, 64^2, 16] f32 at B = 1, 64 and 132 (one image per SM of
          the card), rand maps with a NaN planted in one: v1, the present
          kernel (unrolled 16-byte loads; block 0 pulls the partials over
          distributed shared memory), its TMA bulk-copy variant, the
          other blocks pushing their partials to block 0, block 0
          walking the blocks one after another, an L2 prefetch hint, and
          the read with each block's merge alone (`scan_only`, no
          output: what the cluster merge costs); at B = 1, 8, 32, 64 and
          132 the present kernel and the push under other launches (K
          blocks an image of T threads).

Prints one JSON line per case and the card's name and power limit, and
with --out writes them to that file as JSON. Needs a Hopper card and
nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

VARIANTS = REPO / 'experiments' / 'render_decode_variants.cu'
P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
VARIANT_SIGNATURES = {'hpe_fill_zero_cs': [P, LL, I, P],
                      'hpe_render_gaussian_tma': [P, P, P] + [I] * 5 + [ctypes.c_float, I, P],
                      'hpe_decode_peaks_bulk': [P, P, P] + [I] * 8 + [P],
                      'hpe_decode_peaks_serial': [P, P, P] + [I] * 8 + [P],
                      'hpe_decode_peaks_push': [P, P, P] + [I] * 8 + [P],
                      'hpe_decode_peaks_l2hint': [P, P, P] + [I] * 8 + [P],
                      'hpe_decode_scan_only': [P, P, P] + [I] * 8 + [P]}


def same_decode(a, b) -> bool:
    """Equal coords and maxvals, NaN where the other has NaN."""
    return all(cs.same_nan_and_bits(x, y) for x, y in zip(a, b))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--out', help='also write the cases to this JSON file')
    args = ap.parse_args(argv)
    import torch
    from hourglass_pose_estimation_torch.ops.heatmap import render_preamble
    from hourglass_pose_estimation_torch.ops.hopper import (
        _build, decode_peaks, decode_peaks_reference, render_gaussian)
    from hourglass_pose_estimation_torch.ops.hopper.decode import decode_schedule
    if not torch.cuda.is_available():
        raise SystemExit('needs a CUDA device')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True, text=True).stdout.strip()
    print(f'card: {card}', flush=True)
    started = [cs.start_nvcc(cs.V1_SOURCE), cs.start_nvcc(VARIANTS)]
    _build.library()
    v1 = cs.load_built(started[0], cs.v1_signatures())
    var = cs.load_built(started[1], VARIANT_SIGNATURES)
    dev = torch.device('cuda')
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    results = dict(card=card, cases=[])

    def report(what, entry):
        print(f'{what}: ' + json.dumps(entry), flush=True)
        results['cases'].append(dict(entry, case=what))

    with torch.no_grad():
        # --- render, chip_smoke's inputs
        gen = torch.Generator().manual_seed(7)
        R, J, B = cs.RES, 16, cs.BATCH
        joints = torch.rand(B, J, 2, generator=gen) * 1.4 * R - 0.2 * R
        vis = (torch.rand(B, J, generator=gen) > 0.2).float()
        size = (R // 4, R // 4)
        mu, weight = render_preamble(joints.to(dev), vis.to(dev), size, (R, R), 1)
        ref = cs.render_v1(v1, mu, weight, size, 1)
        n4 = ref.numel() // 4

        def render_tma(m, w):
            out = torch.empty_like(ref)
            _build.check(var.hpe_render_gaussian_tma(
                m.data_ptr(), w.data_ptr(), out.data_ptr(), B, R // 4, R // 4, J, 3,
                2.0, sms, torch.cuda.current_stream().cuda_stream), 'render tma')
            return out

        def zero_cs(mu_, weight_):
            out = torch.empty_like(ref)
            _build.check(var.hpe_fill_zero_cs(out.data_ptr(), n4, sms * 8,
                                              torch.cuda.current_stream().cuda_stream), 'fill')
            return out

        cases = {'v1': lambda m, w: cs.render_v1(v1, m, w, size, 1),
                 'present': lambda m, w: render_gaussian(m, w, size, 1),
                 'tma_store': render_tma,
                 'fill_zero_cs': zero_cs,
                 'torch_zero_': lambda m, w: torch.empty_like(ref).zero_()}
        ulps = {}
        for name in ('present', 'tma_store'):
            got = cases[name](mu, weight)
            torch.cuda.synchronize()
            ulps[name] = int((got.view(torch.int32) - ref.view(torch.int32)).abs().max())
            cs.check(ulps[name] <= cs.RENDER_MAX_ULP, f'render {name}: {ulps[name]} ulp from v1')
        report('render [64,64,64,16] f32 sigma 1',
               dict(bytes=ref.numel() * 4, bound_ms=ref.numel() * 4 / cs.PEAK_BYTES * 1e3,
                    max_ulp_vs_v1=ulps, **cs.in_turns(cases, (mu, weight))))
        del ref, got

        # --- decode at batch 1, 64 and 132
        for b in (1, 8, 32, B, sms):
            hm = torch.rand(b, 64, 64, 16, generator=gen)
            hm[0, 20, 20, 3] = float('nan')
            hm = hm.to(dev)
            sched = decode_schedule(*hm.shape)
            plain = decode_peaks_reference(hm)

            def variant(entry, K=sched[0], T=sched[2], blocks_per_image=1):
                def run(h):
                    n = h.shape[0] * blocks_per_image
                    co = torch.empty((n, 16, 2), dtype=torch.float32, device=dev)
                    mv = torch.empty((n, 16), dtype=torch.float32, device=dev)
                    _build.check(getattr(var, entry)(
                        h.data_ptr(), co.data_ptr(), mv.data_ptr(), *h.shape, K, -(-64 // K),
                        T, 4, torch.cuda.current_stream().cuda_stream), entry)
                    return co, mv
                return run

            def checked(cases):
                for name, fn in cases.items():
                    if name != 'scan_only':
                        cs.check(same_decode(fn(hm), plain),
                                 f'decode b={b}: {name} differs from the plain version')
                return cases

            if b in (1, B, sms):
                # the bulk copy needs the slab in one block's shared memory
                bulk = ({'tma_bulk': variant('hpe_decode_peaks_bulk')}
                        if sched[1] * 64 * 16 * 4 <= 200 * 1024 else {})
                cases = {'v1': lambda h: cs.decode_v1(v1, h), 'present': decode_peaks, **bulk,
                         'push_merge': variant('hpe_decode_peaks_push'),
                         'serial_merge': variant('hpe_decode_peaks_serial'),
                         'l2_prefetch': variant('hpe_decode_peaks_l2hint'),
                         'scan_only': variant('hpe_decode_scan_only',
                                              blocks_per_image=sched[0])}
                report(f'decode [{b},64,64,16] f32',
                       dict(bytes=hm.numel() * 4, bound_ms=hm.numel() * 4 / cs.PEAK_BYTES * 1e3,
                            schedule=dict(zip(('K', 'rows', 'T', 'L'), sched)),
                            **cs.in_turns(checked(cases), (hm,))))

            # the present kernel, and the push merge, under other launches
            # (K blocks an image of T threads)
            def launch_as(K, T):
                def run(h):
                    co = torch.empty((b, 16, 2), dtype=torch.float32, device=dev)
                    mv = torch.empty((b, 16), dtype=torch.float32, device=dev)
                    _build.check(_build.library().hpe_decode_peaks(
                        h.data_ptr(), co.data_ptr(), mv.data_ptr(), *h.shape, K, -(-64 // K),
                        T, 4, torch.cuda.current_stream().cuda_stream), f'K{K} T{T}')
                    return co, mv
                return run
            grid = ((8, 256), (8, 512), (4, 256), (4, 512), (2, 256), (2, 512), (1, 512))
            sweep = {f'K{K}_T{T}': launch_as(K, T) for K, T in grid}
            sweep.update({f'push_K{K}_T{T}': variant('hpe_decode_peaks_push', K, T)
                          for K, T in grid})
            report(f'decode [{b},64,64,16] f32, launches',
                   dict(schedule=dict(zip(('K', 'rows', 'T', 'L'), sched)),
                        **cs.in_turns(checked(sweep), (hm,))))
            del hm, plain
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == '__main__':
    sys.exit(main())
