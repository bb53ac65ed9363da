from .coded import (  # noqa: F401
    CodedDecodeGroup,
    CodedServeGuard,
    FaultInjector,
    ProcessHostPool,
)
from .engine import (  # noqa: F401
    ContinuousEngine,
    Engine,
    GenerationResult,
    ServeReport,
)
from .scheduler import (  # noqa: F401
    DEFAULT_BUCKETS,
    Request,
    RequestResult,
    SlotScheduler,
    bucket_for,
)
from .traffic import DEFAULT_MIX, LengthBand, poisson_trace  # noqa: F401
