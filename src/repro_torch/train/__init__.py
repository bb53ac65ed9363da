# Training: the optimizer, the synthetic data pipeline, the train step and
# the serving half of the train loop, and the two recovery tiers (the disk
# checkpoint in the reference's format, the coded-parity state guard). The
# sharding functions (``train_loop``'s ``*_shardings``) place a step on a
# mesh of ranks.
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint  # noqa: F401
from .data import DataConfig, Prefetcher, SyntheticLM  # noqa: F401
from .elastic import CodedStateGuard, reshard_state  # noqa: F401
from .optimizer import OptConfig, apply_updates, global_norm, init_state, schedule, state_specs  # noqa: F401
from .train_loop import make_ctx, make_decode_step, make_prefill_step, make_train_step  # noqa: F401
