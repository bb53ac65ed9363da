"""All-to-all encode in synchronous systems — the PyTorch/CUDA package.

A port of the JAX package ``repro`` that sits beside it and imports nothing of
it: ``core`` (field arithmetic, plans, the schedule IR, the single-device
executors and the public ``a2a_encode``), ``topo`` (topologies, α-β pricing,
the hierarchical/multilevel/ring/two-level-DFT plans, IR rewrite passes,
calibration and the autotuner), ``obs`` (spans, metrics, trace export and the
calibration feed), ``dist`` (the IR executor on one GPU), ``kernels`` (the
hand-written CUDA kernels with their plain PyTorch versions) and ``convert``
(carrying the reference's plans and arrays across).
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
from .dist import (  # noqa: F401
    butterfly,
    hierarchical_encode,
    ir_encode,
    multilevel_encode,
    ps_encode,
)
