"""Telemetry of the port: the scoped counter groups the engine's launch,
gather and exchange accounting uses, and the exchange byte formula."""
from repro_torch.obs.metrics import CounterGroup  # noqa: F401
from repro_torch.obs.report import dense_exchange_bytes  # noqa: F401
