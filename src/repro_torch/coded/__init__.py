# Coded-system applications of all-to-all encode (DESIGN §2), in PyTorch:
#  - rs_checkpoint:     erasure-coded optimizer/param shards over the DP axis
#  - gradient_coding:   straggler-tolerant coded gradient aggregation
#  - lagrange_compute:  Lagrange Coded Computing (coded matmul) example
from .gradient_coding import aggregate, build_grad_coding, worker_combine  # noqa: F401
from .lagrange_compute import (  # noqa: F401
    LCCPlan,
    build_lcc,
    lcc_compute_and_decode,
    lcc_decode,
    lcc_encode,
    lcc_encode_collective,
    lcc_generator,
    lcc_pad,
)
from .rs_checkpoint import (  # noqa: F401
    build_parity_plan,
    encode_parity,
    encode_parity_collective,
    limbs_to_state,
    recover_lost,
    shard_state_limbs,
    state_to_limbs,
    unshard_state_limbs,
)
