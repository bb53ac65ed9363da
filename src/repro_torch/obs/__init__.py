# Runtime telemetry for the encode pipeline (an own copy of the reference
# package's observability layer; imports the standard library only, and
# repro_torch.topo where it fits α/β).
#
# - trace.py    Tracer/Span: nestable, attributed wall-clock spans; the
#               instrumented layers (ir_encode(tracer=...), the interpret
#               oracle) stamp per-CommRound metadata onto them
# - export.py   Chrome-trace-event JSON (Perfetto-loadable) + JSONL span
#               sinks under results/traces/, and the reader for both
# - metrics.py  process-local counters/gauges/histograms registry with
#               deterministic JSON snapshots (encode.rounds,
#               encode.round_us{level=}, serve.step_us, ...)
# - feed.py     the live calibration loop: traced round spans → per-level
#               α/β refit → persisted where topo.calibrate.load_fitted_costs
#               reads them, plus the predicted-vs-measured drift rows

from .export import (  # noqa: F401
    DEFAULT_TRACE_DIR,
    default_trace_path,
    read_spans,
    spans_to_chrome,
    write_chrome_trace,
    write_spans_jsonl,
)
from .feed import (  # noqa: F401
    comm_round_spans,
    drift_rows,
    feed_calibration,
    fitted_costs_from_trace,
    persist_fitted_costs,
    refit_from_spans,
    round_measurements,
)
from .metrics import (  # noqa: F401
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
)
from .trace import Span, Tracer, current_tracer, set_tracer  # noqa: F401
