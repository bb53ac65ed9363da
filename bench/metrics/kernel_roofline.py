"""The hand kernels' share of their roofline, in %: the least bytes of a
call (as for ``encode_mfu``) at the card's peak memory bandwidth, over the
device time a call of the hand kernels that the files of ``kernels/`` name,
read from the trace. It reads the call's work whatever implements it, so it
is given only in cells where the hand kernels touch every byte of the call."""

from bench.harness import peak_bytes_per_s


def read(run):
    t = run.trace
    if t is None or not t.calls or not t.hand:
        return None
    hand_s = t.op_seconds(in_call=True, names=t.hand) / t.calls
    peak = peak_bytes_per_s(run.kind)
    if hand_s <= 0 or peak is None:
        return None
    return 100.0 * run.least_bytes() / peak / hand_s
