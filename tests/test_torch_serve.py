"""The port's serving driver (``repro_torch.launch.serve``) on the CPU:
``serve()`` at a smoke config returns tokens of the right shape, finite
logits and its timings, with the plain and the int8 cache; ``main()``
runs with the reference's flags; without a card the default device
raises."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.launch import serve as serve_mod
from repro_torch.models import transformer as tfm

# the test workers share the machine's cores: no intra-op thread pool
torch.set_num_threads(1)


@pytest.mark.parametrize("kv_int8", [False, True])
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "gemma-7b"])
def test_serve_on_the_cpu(arch, kv_int8):
    cfg = get_arch(arch).make_smoke()
    gen = torch.Generator().manual_seed(5)
    r = serve_mod.serve(cfg, batch=3, prompt_len=10, gen=5,
                        temperature=0.8, kv_int8=kv_int8, device="cpu",
                        generator=gen)
    assert r.tokens.shape == (3, 5) and r.prompts.shape == (3, 10)
    assert int(r.tokens.min()) >= 0 and int(r.tokens.max()) < cfg.vocab
    # the first token is greedy from the prefill logits
    assert torch.equal(r.tokens[:, 0], r.prefill_logits.argmax(-1))
    assert r.prefill_logits.shape == r.step_logits.shape == (3, cfg.vocab)
    assert torch.isfinite(r.prefill_logits).all()
    assert torch.isfinite(r.step_logits).all()
    t = r.timings()
    assert r.init_s > 0 and r.prefill_s > 0 and r.decode_s > 0
    assert t["prefill_tok_s"] == pytest.approx(30 / r.prefill_s)
    assert t["decode_tok_s"] == pytest.approx(12 / r.decode_s)
    assert t["decode_ms_per_step"] == pytest.approx(r.decode_s / 4 * 1e3)


def test_serve_step_logits_equal_forward():
    """The first decode step's logits equal ``forward`` at the prompt's
    next position, fed the same greedy token (fp32: the reference's 2e-3 /
    2e-2)."""
    cfg = get_arch("minitron-4b").make_smoke()
    params, _ = tfm.init_params(cfg, torch.Generator().manual_seed(1),
                                device="cpu")
    r = serve_mod.serve(cfg, batch=2, prompt_len=6, gen=3, device="cpu",
                        generator=torch.Generator().manual_seed(2),
                        params=params)
    assert r.init_s is None
    toks = torch.cat([r.prompts, r.tokens[:, :1]], dim=1)
    full, _, _ = tfm.forward(params, toks, cfg)
    np.testing.assert_allclose(r.step_logits.numpy(), full[:, 6].numpy(),
                               atol=2e-3, rtol=2e-2)
    np.testing.assert_allclose(r.prefill_logits.numpy(), full[:, 5].numpy(),
                               atol=1e-5, rtol=1e-5)


def test_serve_is_seeded():
    cfg = get_arch("nemotron-4-340b").make_smoke()
    a, b = (serve_mod.serve(cfg, batch=2, prompt_len=4, gen=4, device="cpu",
                            generator=torch.Generator().manual_seed(9))
            for _ in range(2))
    assert torch.equal(a.tokens, b.tokens)


def test_main_runs_with_the_reference_flags(capsys):
    r = serve_mod.main(["--device", "cpu", "--batch", "2", "--prompt-len",
                        "8", "--gen", "3", "--kv-int8", "--arch",
                        "moonshot-v1-16b-a3b", "--temperature", "1.0"])
    out = capsys.readouterr().out
    assert "prefill: 2x8 tokens" in out and "decode: 2 steps" in out
    assert "int8 KV cache" in out
    assert r.tokens.shape == (2, 3)


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch("gemma-7b").make_smoke()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_mod.serve(cfg, batch=1, prompt_len=2, gen=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfm.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_mod.main(["--batch", "1", "--prompt-len", "2", "--gen", "2"])
