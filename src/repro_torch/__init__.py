"""All-to-all encode in synchronous systems — the PyTorch/CUDA package.

A port of the JAX package ``repro`` that sits beside it and imports nothing of
it: ``core`` (field arithmetic, plans, the schedule IR, the single-device
executors and the public ``a2a_encode``), ``dist`` (the IR executor on one
GPU), ``kernels`` (the hand-written CUDA kernels with their plain PyTorch
versions) and ``convert`` (carrying the reference's plans and arrays across).
"""

from .core import (  # noqa: F401
    M31,
    NTT,
    CostModel,
    CostReport,
    Field,
    a2a_encode,
    plan_for,
)
from .dist import butterfly, ir_encode, ps_encode  # noqa: F401
