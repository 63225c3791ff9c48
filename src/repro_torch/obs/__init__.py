"""Telemetry of the port: the scoped counter groups the engine's launch,
gather and exchange accounting uses, the stream service's instruments and
registry, span tracing, run reports and the exchange byte formulas."""
from repro_torch.obs.metrics import (DEPTH_EDGES, LATENCY_EDGES,  # noqa: F401
                                     SLACK_EDGES, Counter, CounterGroup,
                                     Gauge, Histogram, MetricsRegistry,
                                     default_registry, exp_edges)
from repro_torch.obs.report import (RunReport,  # noqa: F401
                                    dense_exchange_bytes,
                                    dense_swap_bytes, exchange_section,
                                    packed_exchange_bytes,
                                    totals_from_trace)
from repro_torch.obs.trace import (Event, Span, Trace,  # noqa: F401
                                   current_trace, maybe_event, maybe_span,
                                   tracing)
