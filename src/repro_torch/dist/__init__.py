"""Executors of compiled round schedules, and the logical-axis sharding
rules.

Layering: ``core`` computes plans (host numpy), ``topo`` prices and rewrites
them on a topology; ``dist`` lowers them onto devices. Two forms share every
plan, lowering and budget: on one device the K processors are the leading
tensor axis (``collectives``); on a mesh of ranks each processor is a
process and each port group a ``torch.distributed`` exchange of messages
(``ranks``, over gloo; NCCL across cards is a later slice, ROADMAP A2).
``sharding`` maps a tensor's logical dims onto mesh axes, places tensors
on a mesh of ranks as DTensors and carries the profile flags the models
read; ``_compat.shard_map`` runs a function on each rank's blocks;
``pipeline`` is GPipe over a mesh axis.
"""

from .sharding import NamedSharding, ShardingRules, constrain, named_sharding, spec_for  # noqa: F401
from ._compat import shard_map  # noqa: F401
from .pipeline import pipeline_apply, stack_stage_params  # noqa: F401

from .collectives import (  # noqa: F401
    KERNEL_MODES,
    allgather_encode,
    butterfly,
    expected_hier_permute_count,
    expected_multilevel_permute_count,
    expected_permute_count,
    hierarchical_encode,
    ir_encode,
    multilevel_encode,
    ps_encode,
    shoot_round_slots,
)
from .ranks import (  # noqa: F401
    allgather_encode_ranks,
    butterfly_ranks,
    gloo_exchange,
    hierarchical_encode_ranks,
    ir_encode_ranks,
    multilevel_encode_ranks,
    ps_encode_ranks,
)
