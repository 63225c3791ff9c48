"""The language-model substrate (``repro/models``): the decoder-only LM
stack (dense and MoE), attention with a KV cache, and the shared building
blocks, as plain PyTorch ops, for serving and, through autograd, for
training. The reference computes all of it with ``jnp`` (no Pallas
kernel), so the port writes no kernel here."""
