# The paper's primary contribution: the all-to-all encode collective
# (Wang & Raviv, "All-to-All Encode in Synchronous Systems", 2022), in PyTorch.
#
# - field.py          GF(q) arithmetic: exact host tier + 32-bit torch device tier
# - matrices.py       Vandermonde / DFT / Lagrange generator constructions
# - schedule.py       static round schedules (prepare/shoot, butterfly, draw/loose)
# - bounds.py         Lemmas 1-2 lower bounds, Theorems 1-4 closed forms, cost model
# - ir.py             unified ScheduleIR: every plan compiles to one round-
#                     schedule representation (+ rewrite passes)
# - simulator.py      cost-exact p-port interpreter for any ScheduleIR
# - prepare_shoot.py  universal algorithm, array-level torch executor
# - draw_loose.py     specific algorithms (butterfly, draw-and-loose, Lagrange)
# - encode.py         public a2a_encode API with auto-selection

from .bounds import CostModel  # noqa: F401
from .encode import CostReport, a2a_encode, default_q_for, plan_for, rs_generator  # noqa: F401
from .field import M31, NTT, Field  # noqa: F401
from .ir import (  # noqa: F401
    CommRound,
    LocalOp,
    ScheduleIR,
    Transfer,
    fuse_trivial_rounds,
    ir_messages,
    ir_permute_count,
    relabel,
    to_ir,
)
from .schedule import (  # noqa: F401
    ButterflyPlan,
    DrawLoosePlan,
    PrepareShootPlan,
    plan_butterfly,
    plan_draw_loose,
    plan_prepare_shoot,
)
from .simulator import SimStats, SyncSimulator, interpret  # noqa: F401
