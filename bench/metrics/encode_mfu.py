"""The whole call's share of the card's roofline, in %: the least bytes the
call's work needs (K source rows read and N coded rows written once, 4 B an
element, whatever the executor pads or repeats) at the card's peak memory
bandwidth, over the mean time of a call on the device's clock. The bytes
bound an encode, not its operations."""

from bench.harness import peak_bytes_per_s


def read(run):
    if not run.completed:
        return None
    peak = peak_bytes_per_s(run.kind)
    if peak is None:
        return None
    mean_s = sum(run.call_s) / run.completed
    return 100.0 * run.least_bytes() / peak / mean_s
