"""The 95th percentile, by nearest rank, of every call completed in the
window, each timed on the device's clock (CUDA events) from just before the
call to the end of the synchronise that ends it."""

from bench.harness import p95


def read(run):
    if not run.completed:
        return None
    return p95(run.call_s) * 1e3
