"""The language-model serving substrate (``repro/models``): the decoder-only
LM stack (dense and MoE), attention with a KV cache, and the shared
building blocks, as plain PyTorch ops. The reference computes all of it
with ``jnp`` (no Pallas kernel), so the port writes no kernel here."""
