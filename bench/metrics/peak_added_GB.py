"""The most device memory the window's calls added, in GB: the allocator's
peak over the window less what was allocated as it began (the inputs, and
the buffers the comparison keeps, are resident by then): a call's output and
its working set."""


def read(run):
    if run.peak_added is None:
        return None
    return run.peak_added / 1e9
