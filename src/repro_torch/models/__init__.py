# The dense, MoE and MLA decoders (layers, mla, model, inputs). The other families wait
# for a later slice: build_model refuses them, naming the ROADMAP item.
from .inputs import batch_dims, make_batch  # noqa: F401
from .layers import NO_CTX, Ctx  # noqa: F401
from .model import Model, build_model  # noqa: F401
