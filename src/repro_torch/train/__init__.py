# Training-side recovery tiers and the serving half of the train loop: the
# disk checkpoint in the reference's format, the coded-parity state guard,
# and the decode/prefill step factories the serving engines run. The
# optimizer, data pipeline and train step wait for ROADMAP queue A item 11.
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint  # noqa: F401
from .elastic import CodedStateGuard  # noqa: F401
from .train_loop import make_ctx, make_decode_step, make_prefill_step  # noqa: F401
