"""train.stage_ms: the program's `train.stage` span's mean device ms a traced
step (the device pipeline: to the device, the augmentation draws, the warp
and the target render), from the CUDA events the span records on the stream
(`hpe_bench/spans.py`). Nothing without the span."""

from hpe_bench import spans


def read(ctx, trace):
    if ctx.get('kind') != 'train':
        return None
    return spans.phase_ms(trace, 'train.stage')
