"""The step builders' LM cases at smoke size on the CPU against the
reference's same case functions (``tests/_steps_run.py``): each LM arch's
training step (Minitron-4B's two microbatches, Nemotron-4-340B's eight
with bf16 optimizer state and gradient accumulation, one for the rest),
prefill, and decode with the plain and the int8 cache (Minitron's ``opt``
and ``opt_int8_half`` too). Tolerances: ``tests/_case_check.py``'s
(``tests/_train_check.py``'s for a training step).
"""
import pytest
import torch

from _case_check import CASES, case_id
from _steps_ref import reference_steps
from _steps_run import check_pair

# the test workers share the machine's cores: no intra-op thread pool
torch.set_num_threads(1)

LM = [c for c in CASES if c[1] in ("train", "prefill", "decode")]


@pytest.fixture
def jsteps(monkeypatch):
    yield from reference_steps(monkeypatch)


@pytest.mark.parametrize("spec", LM, ids=[case_id(c) for c in LM])
def test_lm_case_matches_reference(jsteps, spec):
    check_pair(jsteps, spec)
