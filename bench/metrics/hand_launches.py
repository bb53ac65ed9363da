"""Hand-kernel launches a call, from the program's own counters that the
files of ``kernels/`` name (``launch_counter``: each raised where its kernel
launches), read before and after the window."""

import importlib


def _counter(path: str) -> int:
    module, _, attrs = path.partition(":")
    obj = importlib.import_module(module)
    for attr in attrs.split("."):
        obj = getattr(obj, attr)
    return int(obj)


def _count(run):
    paths = [k["launch_counter"] for k in run.kernels if "launch_counter" in k]
    return sum(_counter(p) for p in paths) if paths else None


def before_window(run):
    run.counters["hand_launches"] = _count(run)


def read(run):
    if not run.attempted or run.counters.get("hand_launches") is None:
        return None
    return (_count(run) - run.counters["hand_launches"]) / run.attempted
