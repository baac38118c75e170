"""train.dispatch_idle: the share of the profiled train steps' window (rank
0's card) in which no kernel ran while the host was inside the program's
`train.forward`, `train.backward` or `train.optimizer` span: the card
waiting on the dispatch of the model's and the optimizer's work
(`hpe_bench/spans.py`). Nothing without the spans."""

from hpe_bench import spans


def read(ctx, trace):
    if ctx.get('kind') != 'train':
        return None
    return spans.dispatch_idle(trace)
