"""All-to-all encode in synchronous systems — the PyTorch/CUDA package.

A port of the JAX package ``repro`` that sits beside it and imports nothing of
it: ``core`` (field arithmetic, plans, the schedule IR, the single-device
executors and the public ``a2a_encode``), ``topo`` (topologies, α-β pricing,
the hierarchical/multilevel/ring/two-level-DFT plans, IR rewrite passes,
calibration and the autotuner), ``obs`` (spans, metrics, trace export and the
calibration feed), ``dist`` (the IR executor on one GPU), ``kernels`` (the
hand-written CUDA kernels with their plain PyTorch versions), ``coded`` (parity,
Lagrange coded computing, gradient coding), ``configs`` and ``models`` (the
reference's configs; the dense decoder), ``train`` (checkpoints, the coded
state guard, the decode/prefill steps), ``serve`` (the fixed-batch and
continuous-batching engines and the coded-serving guard), ``launch`` (the
serving launcher) and ``convert`` (carrying the reference's plans, arrays and
parameters across).
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
