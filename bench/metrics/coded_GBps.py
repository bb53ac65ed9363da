"""The K source rows of every call completed in the window (K x S x 4 B, one
int32 residue an element), in GB, over the window's whole wall time on the
host's clock."""


def read(run):
    if not run.completed or run.window_s <= 0:
        return None
    return run.code["K"] * run.width * 4 * run.completed / run.window_s / 1e9
