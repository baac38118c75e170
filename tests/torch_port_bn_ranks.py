"""One rank of the fused BatchNorm's synced test (gloo, both ranks on one
card or both on the CPU), started by tests/test_torch_port_cuda.py as its
own process:

    RANK=r WORLD_SIZE=2 MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/torch_port_bn_ranks.py <device> <out file>

Each rank normalises its 4 samples of a seeded global batch of 8 under each
synced row rule of CASES (a BatchNorm of 64 channels, the ReLU, an f32
output), takes the backward of a seeded output gradient, and saves the
output, the input's and the affine's gradients and the running averages,
with the fused BatchNorm's launches. On the card the kernels run; on the
CPU their plain versions (held to JAX by the CPU tests) do."""

from __future__ import annotations

import os
import sys
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from hourglass_pose_estimation_torch.models.norm import BatchNorm, sync_batch_norm  # noqa: E402
from hourglass_pose_estimation_torch.ops.hopper import launch_counts  # noqa: E402
from hourglass_pose_estimation_torch.utils import tracing  # noqa: E402

# (rows, stat_samples): a mean of the ranks' moments over each rank's rows
# (all, or its first 2 samples); sums of the global batch's first k rows (k
# = 6: rank 0's 4 and rank 1's first 2; k = 2: rank 0's first 2 alone)
CASES = (('mean', 0), ('mean', 2), ('global', 6), ('global', 2))
BN_OPS = ('batch_norm_train_stats', 'batch_norm_train_fwd', 'batch_norm_train_bwd_reduce',
          'batch_norm_train_bwd')


def main(device: str, out: Path) -> int:
    dist.init_process_group('gloo', timeout=timedelta(seconds=120))
    rank = dist.get_rank()
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(8, 16, 16, 64, generator=gen) * 2 + 0.5
    g = torch.randn(8, 16, 16, 64, generator=gen)
    weight, bias = torch.rand(64, generator=gen) + 0.5, torch.randn(64, generator=gen)
    mine = slice(4 * rank, 4 * rank + 4)
    tracing.reset()
    cases = {}
    for rows, k in CASES:
        bn = BatchNorm(64, stat_samples=k)
        with torch.no_grad():
            bn.weight.copy_(weight)
            bn.bias.copy_(bias)
        sync_batch_norm(bn.to(device), global_rows=rows == 'global')
        xl = x[mine].to(device).permute(0, 3, 1, 2).detach().requires_grad_()
        y = bn(xl, True, relu=True, out_dtype=torch.float32)
        y.backward(g[mine].to(device).permute(0, 3, 1, 2))
        cases[f'{rows}{k}'] = {n: t.detach().cpu() for n, t in (
            ('y', y), ('dx', xl.grad), ('dweight', bn.weight.grad), ('dbias', bn.bias.grad),
            ('running_mean', bn.running_mean), ('running_var', bn.running_var))}
    counts = launch_counts()
    torch.save({'cases': cases, 'launches': {n: counts[n] for n in BN_OPS}}, out)
    dist.destroy_process_group()
    return 0


if __name__ == '__main__':
    if os.environ.get('RANK') is None:
        sys.exit('torch_port_bn_ranks.py: RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT '
                 'must be set')
    sys.exit(main(sys.argv[1], Path(sys.argv[2])))
