"""Telemetry of the port: the scoped counter groups the engine's launch,
gather and exchange accounting uses, the stream service's instruments and
registry, span tracing, run reports and the exchange byte formulas; the
op counter's hooks (``opcost_hooks``) are imported from their module."""
from repro_torch.obs.metrics import (DEPTH_EDGES, LATENCY_EDGES,  # noqa: F401
                                     SLACK_EDGES, Counter, CounterGroup,
                                     Gauge, Histogram, MetricsRegistry,
                                     default_registry, exp_edges)
from repro_torch.obs.report import (RunReport,  # noqa: F401
                                    dense_exchange_bytes,
                                    dense_swap_bytes, exchange_section,
                                    packed_exchange_bytes,
                                    totals_from_trace)
from repro_torch.obs.trace import (Span, Trace, current_trace,  # noqa: F401
                                   maybe_span, profiling, step_span,
                                   tracing)
