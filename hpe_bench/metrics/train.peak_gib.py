"""train.peak_gib: the card's allocated-memory peak over the train window
(`torch.cuda.max_memory_allocated` after a reset at its start; rank 0)."""


def read(ctx, trace):
    if ctx.get('kind') != 'train' or not ctx.get('window_peak_bytes'):
        return None
    return ctx['window_peak_bytes'] / 2 ** 30
