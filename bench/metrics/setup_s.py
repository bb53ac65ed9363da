"""Seconds from the start of the process to the first timed call: imports,
the card's context, the kernels (built in the first run of a checkout), the
payloads made from the seed, the entry's plans and the warm-up calls."""


def read(run):
    return run.setup_s
