"""Executors of compiled round schedules on one device.

Layering: ``core`` computes plans (host numpy); ``dist`` lowers them onto a
device, the K processors being the leading tensor axis. The multi-rank
``torch.distributed`` form of the same executor is a later slice of the port.
"""

from .collectives import (  # noqa: F401
    KERNEL_MODES,
    allgather_encode,
    butterfly,
    expected_permute_count,
    ir_encode,
    ps_encode,
    shoot_round_slots,
)
