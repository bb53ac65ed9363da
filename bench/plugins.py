"""Finding the benchmark's parts by name.

``BENCHMARK.json`` names configurations, traffic mixes and metrics; each is a
file of its own under the benchmark's folder, so a cell, a mix or a metric is
added by adding a file and an entry, never by editing a file that exists:

* ``configs/<name>.json``: a configuration (its code and its payload);
* ``traffic/<name>.json``: a traffic mix (the entry it drives and its loop);
* ``entries/<name>.py``: an entry of the program a mix drives;
* ``payloads/<kind>.py``: how a payload kind is made from the seed;
* ``metrics/<name>.py``: the reader of one metric;
* ``kernels/<name>.json``: a hand-written kernel of the program, by the
  substrings of its name in a trace (``trace_names``) and the program's
  counter of its launches (``launch_counter``, ``module:object.attribute``).
  Every file there is read: a kernel is added by adding its file.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")


def check_name(name: str, what: str) -> str:
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise ValueError(f"bad {what} name {name!r}")
    return name


def path_of(bench: Path, folder: str, name: str, suffix: str) -> Path:
    path = bench / folder / (check_name(name, folder) + suffix)
    if not path.is_file():
        raise FileNotFoundError(f"no {name!r} in {folder}/: {path} is missing")
    return path


def read_json(bench: Path, folder: str, name: str) -> dict:
    with open(path_of(bench, folder, name, ".json")) as f:
        return json.load(f)


def load_module(bench: Path, folder: str, name: str):
    """The module ``<bench>/<folder>/<name>.py``, loaded by its path (a name
    may hold dots) once per process."""
    path = path_of(bench, folder, name, ".py")
    key = f"_bench_{folder}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}_{abs(hash(str(path)))}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[key]
            raise
    return sys.modules[key]


def hand_kernels(bench: Path) -> list[dict]:
    """Every ``kernels/<name>.json``, by name, each with its ``name``."""
    out = []
    for path in sorted((bench / "kernels").glob("*.json")):
        with open(path) as f:
            spec = json.load(f)
        spec["name"] = check_name(path.stem, "kernels")
        out.append(spec)
    return out


def hand_kernel_names(kernels: list[dict]) -> tuple[str, ...]:
    """The substrings by which a trace names the hand kernels."""
    return tuple(n for k in kernels for n in k.get("trace_names", ()))
