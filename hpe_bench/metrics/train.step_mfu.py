"""train.step_mfu: the train window's model FLOPs (three forwards' worth of
the convolutions, from their shapes, for every image stepped) over its
seconds, as a share of the bf16 peak of the cards used."""

from hpe_bench.peaks import PEAK_BF16_FLOPS


def read(ctx, trace):
    if ctx.get('kind') != 'train':
        return None
    return 100.0 * ctx['images'] * ctx['train_flops_per_image'] / (
        ctx['window_s'] * PEAK_BF16_FLOPS * ctx['chips'])
