"""Each kernel byte rule against a count made row by row from tiny
operands, through the port's own entry points on the CPU."""
import pytest
import torch

from bench import catalog, tracing

PAD = 6                     # six graph rows: the pad id and sentinel is 6
ELL = torch.tensor([[1, 2, 6, 6], [0, 6, 6, 6], [0, 3, 4, 5],
                    [2, 6, 6, 6], [2, 5, 6, 6], [2, 4, 6, 6]],
                   dtype=torch.int32)
COLORS = torch.tensor([0, 1, 0, 2, 1, 0, -2], dtype=torch.int32)
PRIO = torch.tensor([5, 3, 9, 1, 7, 2, -1], dtype=torch.int32)
ROWS = torch.tensor([2, 6, 0, 5, 6, 4], dtype=torch.int32)
FLAGS = torch.tensor([True, True, False, True, True, False])


def _record(kernel, call):
    rules = catalog.kernel_rules()
    rec = tracing.Recorder({kernel: rules[kernel]})
    with rec.installed():
        out = call()
    return rec.bytes[kernel], out


def _handed(rows):
    return list(range(ELL.shape[0])) if rows is None else rows.tolist()


def _real(r):
    return [int(v) for v in ELL[r] if v != PAD]


@pytest.mark.parametrize("rows", [None, ROWS])
@pytest.mark.parametrize("hubs", [False, True])
def test_mex_window_rule(rows, hubs):
    from repro_torch.kernels import ops

    window = 4
    handed = _handed(rows)
    base = torch.zeros(len(handed), dtype=torch.int32)
    active = FLAGS[:len(handed)]
    hub_forb = hub_slot = None
    if hubs:
        hub_forb = torch.zeros((3, window), dtype=torch.bool)
        hub_slot = torch.tensor([2, 0, 1, 2, 2, 2], dtype=torch.int32)
    got, _ = _record("mex_window_kernel", lambda: ops.mex_window(
        COLORS, ELL, rows, base, active, hub_forb, hub_slot, window))
    want = 0
    for i, r in enumerate(handed):
        if r >= ELL.shape[0]:
            continue
        want += 1 + 4 + (4 if rows is not None else 0)
        if not active[i]:
            continue
        want += 4 + 8 * len(_real(r))
        if hubs:
            want += 4 + (window if hub_slot[r] < 2 else 0)
    assert got == want


@pytest.mark.parametrize("rows", [None, ROWS])
def test_conflict_rule(rows):
    from repro_torch.kernels import ops

    handed = _handed(rows)
    ids = torch.tensor([min(r, PAD) for r in handed], dtype=torch.int32)
    cu, pu = COLORS[ids.long()], PRIO[ids.long()]
    newly = FLAGS[:len(handed)]
    got, _ = _record("conflict_kernel", lambda: ops.conflict(
        COLORS, PRIO, ELL, rows, cu, pu, ids, newly))
    want = 0
    for i, r in enumerate(handed):
        if r >= ELL.shape[0]:
            continue
        want += 2 + (4 if rows is not None else 0)
        if not newly[i]:
            continue
        want += 12
        for v in _real(r):
            want += 8 + (4 if COLORS[v] == cu[i] else 0)
    assert got == want


@pytest.mark.parametrize("capacity", [None, 2, 8])
@pytest.mark.parametrize("with_values", [False, True])
def test_scan_rule(capacity, with_values):
    from repro_torch.kernels import ops

    mask = torch.tensor([True, False, True, True, False, True, False, False])
    values = None
    sentinel = 9
    if with_values:
        values = torch.tensor([3, 0, 5, 1, 9, 7, 9, 9], dtype=torch.int32)
        mask = mask & (values != sentinel)
    got, (items, count) = _record("scan_kernel", lambda: ops.compact(
        mask, capacity, sentinel if with_values else None, values))
    cap = mask.numel() if capacity is None else capacity
    emitted = min(int(mask.sum()), cap)
    if with_values:
        want = int((values != sentinel).sum()) + 8 * emitted + 4
    else:
        want = mask.numel() + 4 * emitted + 4
    assert got == want
    assert int(count) == int(mask.sum())


def test_rules_name_port_kernels_and_entries():
    """Each rule's kernel is a ``__global__`` function of the port, and its
    entry point exists; the default coloring path's three kernels have
    rules."""
    import importlib

    from repro_torch.kernels._build import CSRC

    names = tracing.port_kernel_names(CSRC)
    rules = catalog.kernel_rules()
    assert {"mex_window_kernel", "conflict_kernel", "scan_kernel"} <= set(rules)
    for kernel, rule in rules.items():
        assert kernel in names
        mod, fn = rule.ENTRY.split(":")
        assert callable(getattr(importlib.import_module(mod), fn))


def test_recorder_restores_entries():
    from repro_torch.kernels import ops

    before = ops.compact
    rec = tracing.Recorder(catalog.kernel_rules())
    with rec.installed():
        assert ops.compact is not before
    assert ops.compact is before
