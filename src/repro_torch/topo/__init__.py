# Topology-aware layer over the flat p-port model (an own copy of the
# reference package's topology layer; imports numpy and repro_torch.core only).
#
# - model.py         declarative topologies (flat, ring, torus, two-level,
#                    recursive hierarchy) + α-β time estimation of arbitrary
#                    round schedules
# - lower.py         ScheduleIR → explicit per-round message maps, hop
#                    counts, link contention (cross-checked vs. the exact
#                    interpreter); every plan lowers through plan.to_ir()
# - hierarchical.py  two-level prepare-and-shoot, recursive multi-level
#                    encode (K = Π K_j), Cooley–Tukey two-level AND
#                    multi-level DFT, ring-optimized schedule — all compiled
#                    to ScheduleIR and simulated by core.simulator.interpret
# - passes.py        the pass-pipeline optimizer: named, composable IR
#                    rewrites with applicability predicates (remap_digits,
#                    split_contended, fuse_rounds, align_subgroups) and the
#                    PassPipeline registry the autotuner enumerates
# - calibrate.py     least-squares per-level α/β from measured sweeps +
#                    load_fitted_costs (persisted calibration → LinkCosts)
# - autotune.py      per-(K, p, payload, topology) selection by enumerating
#                    and pricing (algorithm, pipeline) ScheduleIR candidates,
#                    with a measured-override hook
#
# The ONE executor for any IR is dist/collectives.ir_encode; the
# per-algorithm *_encode entry points dispatch through it.

from .autotune import Candidate, TuneResult, autotune, candidates_for  # noqa: F401
from .calibrate import (  # noqa: F401
    fit_level_costs,
    load_fitted_costs,
    round_features,
)
from .hierarchical import (  # noqa: F401
    HierarchicalPlan,
    MultiLevelDFTPlan,
    MultiLevelPlan,
    RingPlan,
    TwoLevelDFTPlan,
    hierarchical_coeff_tensor,
    multilevel_coeff_tensor,
    multilevel_dft_matrix,
    multilevel_level_slots,
    multilevel_live_mask,
    multilevel_message_size,
    plan_hierarchical,
    plan_multilevel,
    plan_multilevel_dft,
    plan_ring,
    plan_two_level_dft,
    simulate_hierarchical,
    simulate_multilevel,
    simulate_ring_encode,
    simulate_two_level_dft,
    two_level_dft_matrix,
)
from .lower import LoweredSchedule, lower, lower_allgather, lower_ir  # noqa: F401
from .model import (  # noqa: F401
    DCI,
    ICI,
    FullyConnected,
    Hierarchy,
    LinkCost,
    Ring,
    TimeEstimate,
    Topology,
    Torus2D,
    Torus3D,
    TwoLevel,
    default_level_costs,
    default_levels,
    make_topology,
    schedule_time,
)
from .passes import (  # noqa: F401
    PASSES,
    PIPELINES,
    Pass,
    PassPipeline,
    align_subgroups,
    fuse_rounds,
    ir_time,
    max_round_hops,
    pipelines_for,
    remap_digits,
    split_contended,
)
