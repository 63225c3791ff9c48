"""Shared harness of the stream service's parity tests
(``tests/test_torch_stream.py``, ``tests/test_torch_stream_b.py``): one
scenario runs against ``repro``'s stream service and against the port's
(``device="cpu"``) on the same requests, and the two runs must agree in
every ticket (status, reason, rounds, chunks, clock stamps, result) and in
``stats()``. The request pool is ``tests/test_stream.py``'s."""
import dataclasses
import random

import numpy as np
import torch

import repro.core.policy as jpolicy
import repro.serve as jserve
import repro_torch.core.policy as tpolicy
import repro_torch.serve as tserve
from repro.exec import ExecutionSpec as JSpec
from repro.exec import Session as JSession
from repro.graphs import get_dataset as jget
from repro_torch.exec import ExecutionSpec as TSpec
from repro_torch.exec import Session as TSession
from repro_torch.graphs import get_dataset as tget

# the test workers share the machine's cores: no intra-op thread pool
torch.set_num_threads(1)

#: tests/test_stream.py's pool: sizes straddle several hundred to several
#: thousand nodes (iteration counts differ) on one node rung, plus a
#: duplicate request (the same Graph object)
POOL_SPECS = [("europe_osm_s", 0.001), ("hollywood-2009_s", 0.005),
              ("soc-LiveJournal1_s", 0.01), ("europe_osm_s", 0.004),
              ("kron_g500-logn21_s", 0.003), ("hollywood-2009_s", 0.02)]


@dataclasses.dataclass(frozen=True)
class Side:
    """One package's stream surface."""

    name: str
    session: object        # (**kw) -> Session
    Spec: type
    Config: type
    Clock: type
    policy: object         # the core.policy module
    get: object            # get_dataset

    def graph(self, name, scale, seed=0, layout="ell-tail"):
        return self.get(name, scale=scale, seed=seed, layout=layout,
                        ell_cap=128)


REF = Side("repro", lambda **kw: JSession(**kw), JSpec, jserve.StreamConfig,
           jserve.ManualClock, jpolicy, jget)
PORT = Side("repro_torch", lambda **kw: TSession("cpu", **kw), TSpec,
            tserve.StreamConfig, tserve.ManualClock, tpolicy, tget)

_POOLS: dict = {}


def pool(side: Side) -> list:
    if side.name not in _POOLS:
        p = [side.graph(n, s, seed=i) for i, (n, s) in enumerate(POOL_SPECS)]
        _POOLS[side.name] = p + [p[0]]
    return _POOLS[side.name]


def order(graphs, how, seed=0) -> list:
    idx = list(range(len(graphs)))
    if how == "asc":
        idx.sort(key=lambda i: graphs[i].n_nodes)
    elif how in ("desc", "big-first"):
        idx.sort(key=lambda i: -graphs[i].n_nodes)
    elif how == "shuffled":
        random.Random(seed).shuffle(idx)
    return idx


TICKET_FIELDS = ("seq", "n_nodes", "priority", "deadline_at", "status",
                 "reason", "admit_round", "drain_round", "chunks")
STAMPS = ("enqueue_s", "admit_s", "drain_s")
RESULT_FIELDS = ("n_colors", "iterations", "mode_trace", "counts",
                 "host_dispatches")


def assert_same_tickets(got, want, *, stamps=True) -> None:
    """Ticket for ticket: the scheduling fields, the clock stamps (exact
    under a ``ManualClock``; ``stamps=False`` on the wall clock) and the
    result."""
    assert len(got) == len(want)
    fields = TICKET_FIELDS + (STAMPS if stamps else ())
    for g, w in zip(got, want):
        assert [getattr(g, f) for f in fields] == \
            [getattr(w, f) for f in fields]
        assert (g.result is None) == (w.result is None)
        if g.result is None:
            continue
        np.testing.assert_array_equal(g.result.colors, w.result.colors)
        assert g.result.colors.dtype == w.result.colors.dtype
        assert [getattr(g.result, f) for f in RESULT_FIELDS] == \
            [getattr(w.result, f) for f in RESULT_FIELDS]
        if stamps:
            assert g.result.total_seconds == w.result.total_seconds


def stats(stream) -> dict:
    """``stats()`` without its one wall-clock field."""
    out = stream.stats()
    out.pop("dispatch_seconds")
    return out


def assert_same_streams(got, want, *, stamps=True) -> None:
    """``(tickets, stream)`` pairs of the two packages agree."""
    assert_same_tickets(got[0], want[0], stamps=stamps)
    assert stats(got[1]) == stats(want[1])


def both(scenario):
    """``scenario(side)`` on the reference, then on the port."""
    return scenario(REF), scenario(PORT)


_SOLO: dict = {}


def assert_port_matches_solo(spec, tickets) -> None:
    """Every ticket done and equal to the port's solo host-regime run."""
    for tk in tickets:
        assert tk.status == "done", (tk.status, tk.reason)
        key = (spec.static_key(), id(tk.graph))
        if key not in _SOLO:
            _SOLO[key] = (tk.graph, TSession("cpu").run(spec, tk.graph))
        ref = _SOLO[key][1]
        np.testing.assert_array_equal(tk.result.colors, ref.colors)
        assert (tk.result.n_colors, tk.result.iterations,
                tk.result.mode_trace) == (ref.n_colors, ref.iterations,
                                          ref.mode_trace)
