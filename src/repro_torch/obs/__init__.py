"""Observability for the refresh engine: span tracing (``obs.trace``) and the
metrics registry (``obs.metrics``). Both are stdlib-only and off unless
``SC_TRACE`` is set or ``trace.enable()`` is called; tracing is passive."""
from . import metrics, trace
from .metrics import METRICS, MetricsRegistry
from .trace import Span

__all__ = ["trace", "metrics", "METRICS", "MetricsRegistry", "Span"]
