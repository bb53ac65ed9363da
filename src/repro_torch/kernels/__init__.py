"""Hand-written CUDA kernels of the port (sources under ``repro_torch/csrc``).

Each kernel sub-package mirrors the reference's layout: ``kernel.py`` (the
ctypes wrapper with its launch counter, and the plain PyTorch version of the
same function), ``ops.py`` (the public names; a CUDA tensor goes to the kernel
or raises, a CPU tensor goes to the plain version) and ``ref.py`` (oracles).
"""
