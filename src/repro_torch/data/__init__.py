"""Deterministic synthetic data pipelines with per-host sharding
(``repro/data``). The LM token pipeline is ported; the recsys one waits
for the DLRM model."""
