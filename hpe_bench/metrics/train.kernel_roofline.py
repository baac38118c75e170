"""train.kernel_roofline: over every launch of a port kernel in the profiled
train steps, the sum of each launch's roofline bound (operations and bytes
from its op's shapes, `hpe_bench/roofline/`) over the sum of its device
time. Nothing when no port kernel ran."""

from hpe_bench import kernels


def read(ctx, trace):
    if ctx.get('kind') != 'train' or trace is None:
        return None
    return roofline_share(trace['port'], ctx)


def roofline_share(port, ctx):
    bound = spent = 0.0
    for launch in port:
        spec = kernels.KERNELS.get(launch['op'])
        if spec is None:
            continue
        bound += kernels.bound_s(*spec[1](launch['shapes'], ctx))
        spent += launch['seconds']
    return 100.0 * bound / spent if spent > 0 else None
