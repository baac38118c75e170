"""train.exchange_ms: the program's `train.exchange` spans' device ms a traced
step, summed over a step's exchange units (HRNet's: the 1x1 and strided
ConvBNs, the upsample-adds, the sum and the ReLU of the forward; their
backward runs inside `train.backward`), from the CUDA events the spans
record on the stream (`hpe_bench/spans.py`). Nothing without the spans."""

from hpe_bench import spans


def read(ctx, trace):
    if ctx.get('kind') != 'train':
        return None
    return spans.phase_ms(trace, 'train.exchange')
