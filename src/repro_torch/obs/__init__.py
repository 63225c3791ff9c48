"""Telemetry of the port: for now only the scoped counter groups the
engine's launch and gather accounting uses."""
from repro_torch.obs.metrics import CounterGroup  # noqa: F401
