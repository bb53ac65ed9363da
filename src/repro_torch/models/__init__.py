# Every family of the registry (layers, mla, ssm, model) and its inputs:
# concrete batches and meta specs.
from .inputs import batch_dims, decode_input_specs, make_batch, train_batch_specs  # noqa: F401
from .layers import NO_CTX, Ctx  # noqa: F401
from .model import Model, build_model  # noqa: F401
