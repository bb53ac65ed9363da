# Coded serving guards (any (cache, state) pytree; no engine needed). The
# continuous-batching engine they plug into waits for the models' port.
from .coded import (  # noqa: F401
    CodedDecodeGroup,
    CodedServeGuard,
    FaultInjector,
    ProcessHostPool,
)
