"""Process-group initialisation for training on several ranks.

Port of `hourglass_pose_estimation_tpu/parallel/multihost.py::
maybe_initialize_distributed`. JAX runs one process per host over a global
mesh; the port runs one process per rank, as `torchrun` starts them:

    torchrun --nproc_per_node N -m hourglass_pose_estimation_torch.train_and_evaluate <yaml>

Every rank loads its contiguous slice of each global batch
(`data.Loader(shard=(rank, world))`, the same seed, so the same global
order on every rank) and steps it; `global_batch_from_local` has nothing
to assemble, and its counterpart is the all-reduce of the step metrics and
of the validation sums.

The backend and the device are explicit: NCCL and cuda:LOCAL_RANK by
default; gloo when the caller asks for the CPU, or asks for it to run two
ranks on one card (`device='cuda:0', backend='gloo'`: NCCL refuses two
ranks on one device). A failed initialisation raises: nothing falls back
to one process or to the CPU.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from hourglass_pose_estimation_torch._device import resolve_device

# the variables torchrun sets for each rank
ENV = ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR', 'MASTER_PORT')


def maybe_initialize_distributed(device='cuda', backend: Optional[str] = None,
                                 timeout: Optional[float] = None,
                                 verbose: bool = True) -> Tuple[int, int]:
    """Initialize the default process group from torchrun's environment ->
    (rank, world size).

    Without WORLD_SIZE in the environment this is a no-op that returns
    (0, 1); with a process group already initialized it returns its place.
    `device` 'cpu' takes gloo; a CUDA device without an index becomes
    cuda:LOCAL_RANK, which is made the current device, with NCCL unless
    `backend` names gloo. `timeout` (seconds) bounds the rendezvous and
    every collective (PyTorch's default when None)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if 'WORLD_SIZE' not in os.environ:
        return 0, 1
    missing = [k for k in ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f'WORLD_SIZE is set but {missing} are not: start the ranks '
                           'with torchrun, which sets ' + ', '.join(ENV))
    rank, world = int(os.environ['RANK']), int(os.environ['WORLD_SIZE'])
    local = int(os.environ['LOCAL_RANK'])
    dev = resolve_device(device)
    if dev.type == 'cpu':
        if backend not in (None, 'gloo'):
            raise ValueError(f'backend {backend!r} on the CPU: only gloo runs there')
        backend = 'gloo'
    else:
        if dev.index is None:
            if local >= torch.cuda.device_count():
                raise RuntimeError(f'LOCAL_RANK {local} but {torch.cuda.device_count()} '
                                   "CUDA devices: give each rank a card, or ask for "
                                   "device='cuda:0' and backend='gloo'")
            dev = torch.device('cuda', local)
        torch.cuda.set_device(dev)
        backend = backend or 'nccl'
    kwargs = {}
    if timeout is not None:
        kwargs['timeout'] = datetime.timedelta(seconds=timeout)
    if backend == 'nccl':
        kwargs['device_id'] = dev
    dist.init_process_group(
        backend, init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        rank=rank, world_size=world, **kwargs)
    if verbose:
        print(f'=> torch.distributed: rank {rank}/{world} ({backend}, {dev})', flush=True)
    return rank, world
