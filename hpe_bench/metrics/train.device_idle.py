"""train.device_idle: the share of the profiled train steps' window (rank 0's
card) in which no kernel ran; busy time is the union of the kernels'
intervals, so overlapping streams count once."""


def read(ctx, trace):
    if ctx.get('kind') != 'train' or trace is None or trace['window_s'] <= 0:
        return None
    return 100.0 * (1.0 - trace['busy_s'] / trace['window_s'])
