"""train.forward_ms: the program's `train.forward` span's mean device ms a
traced step (the models' forward and the loss: train-mode BatchNorm, pool,
upsample), from the CUDA events the span records on the stream
(`hpe_bench/spans.py`). Nothing without the span."""

from hpe_bench import spans


def read(ctx, trace):
    if ctx.get('kind') != 'train':
        return None
    return spans.phase_ms(trace, 'train.forward')
