"""The comparison that decides ``correct``, driven through the rest of a run
on the CPU at a tiny size: sound runs pass; the control (the program's
fused one-pass steps in place of the stated two-phase iterations) and the
timed path broken underneath each come out not correct."""
import dataclasses

import pytest
import torch

from bench import catalog, control, harness

TINY = {"kron_g500.solve": {"scale": 7, "edgefactor": 16, "A": 0.57,
                            "B": 0.19, "C": 0.19}}
SEED = 2**31 + 11
#: sound runs and the control, each on three seeds (one above 32 bits)
SEEDS = [SEED, 5, 2**33 + 7]


def _cell(name):
    cell = catalog.load_cell(name)
    return dataclasses.replace(cell,
                               config={**cell.config, "params": TINY[name]})


def _run(name, seed=SEED, **kw):
    return harness.run_cell(_cell(name), seed, 0.05, False, device="cpu",
                            **kw)


@pytest.mark.parametrize("name", sorted(TINY))
@pytest.mark.parametrize("seed", SEEDS)
def test_sound_run_is_correct(name, seed):
    out = _run(name, seed)
    assert out["correct"] is True
    assert out["checks"] == {"wrong_colorings": {"value": 0, "limit": 0},
                             "nodes_differ": {"value": 0, "limit": 0}}
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"setup_s", "color_s", "peak_gib"}


@pytest.mark.parametrize("name", sorted(TINY))
@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_not_correct(name, seed):
    out = _run(name, seed, spec_overrides=control.CONTROL)
    assert out["correct"] is False
    assert out["checks"]["nodes_differ"]["value"] > 0


def test_control_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert control.main(["--workload", "kron_g500.solve", "--seconds", "1",
                         "--seeds", "1"]) != 0
    assert "CUDA card" in capsys.readouterr().err


def _unchanged(ig, colors, aux, wl, **kw):
    return colors, aux, wl


def _half_of_worklist(step):
    def run(ig, colors, aux, wl, **kw):
        from repro_torch.core.worklist import Worklist
        items = wl.items.clone()
        items[wl.capacity // 2:] = ig.n_nodes
        return step(ig, colors, aux, Worklist(mask=wl.mask, items=items,
                                              count=wl.count), **kw)
    return run


def _altered(finalize):
    def run(self, colors):
        out, n = finalize(self, colors)
        out = out.copy()
        out[0] += 1
        return out, n
    return run


@pytest.mark.parametrize("name", sorted(TINY))
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    from repro_torch.algos.base import Algorithm
    from repro_torch.core import ipgc

    if fault == "unchanged":
        monkeypatch.setattr(ipgc, "dense_step", _unchanged)
        monkeypatch.setattr(ipgc, "sparse_step", _unchanged)
    elif fault == "half":
        monkeypatch.setattr(ipgc, "sparse_step",
                            _half_of_worklist(ipgc.sparse_step))
    else:
        monkeypatch.setattr(Algorithm, "finalize",
                            _altered(Algorithm.finalize))
    out = _run(name)
    assert out["correct"] is False
    assert out["checks"]["wrong_colorings"]["value"] >= 1


def test_reference_coloring_must_be_proper(monkeypatch):
    ref = _cell("kron_g500.solve").reference()
    real = ref.ipgc

    def broken(s, d, n):
        c = real(s, d, n)
        c.colors = torch.zeros_like(c.colors)
        return c
    monkeypatch.setattr(ref, "ipgc", broken)
    with pytest.raises(RuntimeError, match="not proper"):
        _run("kron_g500.solve")
