"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` of this package becomes one shared library with a plain C
interface (no PyTorch headers, so ``nvcc`` needs seconds), loaded with
``ctypes``. The libraries are built at first use — when a CUDA tensor first
reaches a kernel wrapper, never at import — all sources at once, one ``nvcc``
process each, started together. They go to ``build/repro_torch/`` at the root
of the checkout under a name
keyed by a hash of the source and the flags, so an edited source is rebuilt
and an unchanged one is not. A failed build raises with the compiler's
output; nothing falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"

NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_libs: dict[str, ctypes.CDLL] = {}
#: what the last build in this process did: seconds, and per source the
#: library path, whether it was compiled now, and the compiler's log
#: (``-Xptxas -v``: registers, shared memory and spills of each kernel)
build_report: dict = {}


def build_dir() -> Path:
    # src/repro_torch/kernels/_build.py -> the checkout's root
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(os.path.join(os.environ[var], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked on PATH, in $CUDA_HOME/bin and /usr/local/cuda/bin): "
        "the CUDA kernels of repro_torch cannot be built on this machine"
    )


def sources() -> dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _target(src: Path, out_dir: Path) -> Path:
    h = hashlib.sha256()
    h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return out_dir / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing; returns name → path."""
    t0 = time.perf_counter()
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = sources()
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    targets = {name: _target(src, out_dir) for name, src in srcs.items()}
    report = {name: {"library": str(t), "compiled": False, "log": ""} for name, t in targets.items()}
    jobs = []
    nvcc = None
    for name, src in srcs.items():
        if targets[name].exists():
            continue
        nvcc = nvcc or find_nvcc()
        tmp = targets[name].with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((name, tmp, cmd, proc))
    failures = []
    for name, tmp, cmd, proc in jobs:
        log, _ = proc.communicate()
        report[name]["log"] = log
        if proc.returncode != 0:
            failures.append(f"$ {' '.join(cmd)}\n(exit {proc.returncode})\n{log}")
            if tmp.exists():
                tmp.unlink()
            continue
        os.replace(tmp, targets[name])
        report[name]["compiled"] = True
    build_report.clear()
    build_report.update(seconds=time.perf_counter() - t0, sources=report)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return targets


def load_library(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu`` (built on first use)."""
    if name not in _libs:
        targets = build_all()
        if name not in targets:
            raise KeyError(f"no CUDA source csrc/{name}.cu")
        _libs[name] = ctypes.CDLL(str(targets[name]))
    return _libs[name]
