"""Structured event tracing keyed by window coordinates.

Rebuild of the reference's custom event tracer (``src/common/trace.{c,h}``,
STARNEIG_ENABLE_EVENTS; SURVEY.md section 5): the reference records
per-worker {label, t_begin, t_end, window rect, color} ring buffers inside
kernels and dumps ``trace.dat`` for the C++ event parser
(``misc/event_parser/parse.cpp``) to render into matrix-activity images.

Here events are recorded host-side around kernel dispatches (the XLA
profiler covers in-device timing; this layer captures the *algorithmic*
structure: which window of the matrix each step touched).  Events dump to
JSON for the native renderer in ``native/trace_render.cpp`` (images) or any
offline tooling.  Enable via ``enable_tracing()`` or STARNEIG_TRACE=1.
"""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from typing import List, Optional, Tuple

_EVENTS: List[dict] = []
_ENABLED = bool(int(os.environ.get("STARNEIG_TRACE", "0")))
_T0 = time.time()


def tracing_enabled() -> bool:
    return _ENABLED


def enable_tracing() -> None:
    global _ENABLED, _T0
    _ENABLED = True
    _T0 = time.time()
    _EVENTS.clear()


def disable_tracing() -> None:
    global _ENABLED
    _ENABLED = False


def trace_event(label: str, t_begin: float, t_end: float,
                rect: Optional[Tuple[int, int, int, int]] = None,
                **extra) -> None:
    """Record one event; rect = (row, col, height, width) in matrix coords."""
    if not _ENABLED:
        return
    _EVENTS.append({
        "label": label,
        "begin": t_begin - _T0,
        "end": t_end - _T0,
        "rect": list(rect) if rect is not None else None,
        **extra,
    })


@contextmanager
def trace_span(label: str, rect: Optional[Tuple[int, int, int, int]] = None,
               **extra):
    """Context manager variant (the reference's EVENT_BEGIN/END pair)."""
    if not _ENABLED:
        yield
        return
    t0 = time.time()
    try:
        yield
    finally:
        trace_event(label, t0, time.time(), rect, **extra)


def dump_trace(path: str = "trace.json", n: Optional[int] = None) -> str:
    """Write recorded events to JSON (the reference's trace.dat analogue)."""
    with open(path, "w") as f:
        json.dump({"n": n, "events": _EVENTS}, f)
    return path
