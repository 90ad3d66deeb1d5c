"""Observability for the refresh engine: span tracing (``obs.trace``), the
metrics registry (``obs.metrics``), the predicted-vs-realized plan audit
(``obs.audit``) and Chrome-trace export / validation / real-vs-sim diff
(``obs.export``). Tracing is stdlib-only and off unless ``SC_TRACE`` is set
or ``trace.enable()`` is called; it is passive. ``audit`` and ``export`` are
imported by their consumers (``tools/sc_trace_torch.py``), not here."""
from . import metrics, trace
from .metrics import METRICS, MetricsRegistry
from .trace import Span

__all__ = ["trace", "metrics", "METRICS", "MetricsRegistry", "Span"]
