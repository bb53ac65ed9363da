"""Span export: Chrome-trace-event JSON (Perfetto-loadable) and JSONL sinks.

Two formats, one source of truth (:class:`~repro_torch.obs.trace.Span`):

* :func:`write_chrome_trace` — the Trace Event Format's ``"X"`` complete
  events (``{"name", "ph": "X", "ts", "dur", "pid", "tid", "args"}``), one
  per span, sorted by start time. Load the file in Perfetto / ``chrome://
  tracing``; nesting renders from event containment on one track. Span
  attributes travel in ``args`` (JSON-safe stringification for anything
  exotic), so the per-round ``CommRound`` metadata — round index, transfer
  count, predicted µs — is inspectable in the UI and machine-checkable.
* :func:`write_spans_jsonl` — one span dict per line under
  ``results/traces/`` by default: the machine-first sink
  ``repro_torch.obs.feed`` consumes.

:func:`read_spans` loads either format back into plain span dicts (the
shape ``Span.to_dict`` produces), so every downstream consumer is
indifferent to which file it was handed.
"""

from __future__ import annotations

import json
import os

#: repo-root-relative default sink directory for traces
DEFAULT_TRACE_DIR = os.path.join(
    os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ),
    "results",
    "traces",
)


def _as_dicts(spans) -> list[dict]:
    out = []
    for s in spans:
        out.append(s if isinstance(s, dict) else s.to_dict())
    return out


def _json_safe(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    try:  # numpy scalars
        return v.item()
    except AttributeError:
        return str(v)


def spans_to_chrome(spans, *, pid: int = 0, process_name: str = "repro") -> dict:
    """Spans → a Trace Event Format dict (``traceEvents`` of ``"X"`` complete
    events on one track, start-time sorted; a leading process-name metadata
    event labels the track in Perfetto)."""
    events = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": pid,
            "tid": 0,
            "args": {"name": process_name},
        }
    ]
    for sp in sorted(_as_dicts(spans), key=lambda d: d["ts_us"]):
        events.append(
            {
                "name": sp["name"],
                "ph": "X",
                "ts": float(sp["ts_us"]),
                "dur": max(float(sp["dur_us"]), 0.0),
                "pid": pid,
                "tid": 0,
                "args": _json_safe(sp.get("attrs", {})),
            }
        )
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(spans, path: str, **kw) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(spans_to_chrome(spans, **kw), fh, indent=2)
    return path


def write_spans_jsonl(spans, path: str) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        for sp in _as_dicts(spans):
            fh.write(json.dumps(_json_safe(sp)) + "\n")
    return path


def default_trace_path(name: str, kind: str = "jsonl") -> str:
    """``results/traces/<name>.trace.json`` (chrome) or ``.jsonl`` (spans)."""
    ext = "trace.json" if kind == "chrome" else "jsonl"
    return os.path.join(DEFAULT_TRACE_DIR, f"{name}.{ext}")


def read_spans(path: str) -> list[dict]:
    """Load spans back from either sink format (see module doc)."""
    with open(path) as fh:
        text = fh.read()
    if path.endswith(".jsonl"):
        return [json.loads(line) for line in text.splitlines() if line.strip()]
    record = json.loads(text)
    if isinstance(record, list):  # bare span-dict list
        return record
    spans = []
    for ev in record.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        spans.append(
            {
                "name": ev["name"],
                "ts_us": float(ev["ts"]),
                "dur_us": float(ev.get("dur", 0.0)),
                "depth": 0,
                "parent": None,
                "attrs": dict(ev.get("args", {})),
            }
        )
    return spans
