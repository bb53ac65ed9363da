# Training-side recovery tiers (the parts that need no model): the disk
# checkpoint in the reference's format and the coded-parity state guard.
# The optimizer, data pipeline and train loop wait for the models' port.
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint  # noqa: F401
from .elastic import CodedStateGuard  # noqa: F401
