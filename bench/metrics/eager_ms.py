"""Device ms a call in every operation but the hand kernels (those the files
of ``kernels/`` name): the eager PyTorch work of the executors and the field
tier (element-wise, copies, gathers), summed over the operations that
started inside a call."""


def read(run):
    t = run.trace
    if t is None or not t.calls:
        return None
    total = t.op_seconds(in_call=True)
    hand = t.op_seconds(in_call=True, names=t.hand) if t.hand else 0.0
    return (total - hand) / t.calls * 1e3
