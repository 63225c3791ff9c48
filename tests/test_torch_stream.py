"""The port's stream service (``repro_torch/serve/stream.py``) against
``repro``'s, part one (``tests/test_stream.py``'s contracts): results for
any arrival order and algorithm, chunk cadences, mixed layouts, the
scheduler invariants on fixed draws, the queue bound, latency stamps and
overload — every ticket and ``stats()`` equal to the reference's under a
``ManualClock``, and every result equal to the port's solo run."""
import random

import pytest

from _torch_stream import (PORT, REF, assert_port_matches_solo,
                           assert_same_streams, both, order, pool, stats)


def _spec(side, **kw):
    return side.Spec(regime="host", **{"window": 64, **kw})


# ---------------------------------------------------------------------------
# streamed == reference == solo, per request, for any arrival order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arrival", ["asc", "desc", "shuffled", "big-first"])
@pytest.mark.parametrize("algo,fused", [("ipgc", False), ("ipgc", True),
                                        ("jpl", None),
                                        ("spec-greedy", None)])
def test_stream_matches_reference_for_any_arrival(algo, fused, arrival):
    def run(side):
        stream = side.session().stream(
            _spec(side, algo=algo, fused=fused),
            side.Config(lanes=2, chunk=3, clock=side.Clock(tick=0.25)))
        p = pool(side)
        tickets = [stream.submit(p[i]) for i in order(p, arrival)]
        stream.drain()
        return tickets, stream

    want, got = both(run)
    assert_same_streams(got, want)
    assert_port_matches_solo(_spec(PORT, algo=algo, fused=fused), got[0])


def test_stream_chunk_cadence_never_changes_results():
    def run(side, chunk):
        return side.session().stream(
            _spec(side), side.Config(lanes=2, chunk=chunk)).run(pool(side))

    base = None
    for chunk in (1, 7, "auto", "custom"):
        want = run(REF, REF.policy.AdaptiveChunk(min_iters=1, max_iters=4)
                   if chunk == "custom" else chunk)
        got = run(PORT, PORT.policy.AdaptiveChunk(min_iters=1, max_iters=4)
                  if chunk == "custom" else chunk)
        base = base or got
        for g, w, b in zip(got, want, base):
            for other in (w, b):
                assert (g.colors == other.colors).all()
                assert (g.iterations, g.mode_trace, g.n_colors) == \
                    (other.iterations, other.mode_trace, other.n_colors)


def test_stream_mixed_layouts_and_auto_window():
    # hub-split and ell-tail members land in different lane groups but
    # one stream schedules both; window="auto" also varies per graph
    def run(side):
        gs = [side.graph("europe_osm_s", 0.002),
              side.graph("hollywood-2009_s", 0.01, layout="hub-split"),
              side.graph("europe_osm_s", 0.004)]
        stream = side.session().stream(
            side.Spec(regime="host"),
            side.Config(lanes=2, chunk=2, clock=side.Clock(tick=1.0)))
        tickets = [stream.submit(g) for g in gs]
        stream.drain()
        return tickets, stream

    want, got = both(run)
    assert len(got[1]._groups) >= 2
    assert_same_streams(got, want)
    assert_port_matches_solo(PORT.Spec(regime="host"), got[0])


def test_stream_run_matches_run_batch():
    s = PORT.session()
    spec = _spec(PORT)
    streamed = s.stream(spec, PORT.Config(lanes=4)).run(pool(PORT))
    batched = s.run_batch(spec, pool(PORT))
    want = REF.session().stream(_spec(REF), REF.Config(lanes=4)).run(
        pool(REF))
    for r, b, w in zip(streamed, batched, want):
        for other in (b, w):
            assert (r.colors == other.colors).all()
            assert (r.iterations, r.mode_trace) == (other.iterations,
                                                    other.mode_trace)


def test_stream_rejects_unbatchable_specs_loudly():
    import numpy as np
    s = PORT.session()
    with pytest.raises(ValueError, match="regime"):
        s.stream(PORT.Spec(regime="outlined"))
    with pytest.raises(ValueError, match="monotone"):
        s.stream(PORT.Spec(regime="host", mode="hybrid-auto"))
    stream = s.stream(PORT.Spec(regime="host"))
    with pytest.raises(TypeError, match="host Graph"):
        stream.submit(np.arange(3))
    g = PORT.get("kron_g500-logn21_s", scale=0.01, layout="csr-segment")
    with pytest.raises(NotImplementedError, match="csr-segment"):
        stream.submit(g)


# ---------------------------------------------------------------------------
# scheduler invariants, on fixed draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,lanes,chunk,dups", [(0, 1, 1, 1), (1, 2, 4, 2),
                                                   (7, 2, 2, 3)])
def test_stream_scheduler_invariants(seed, lanes, chunk, dups):
    def run(side):
        stream = side.session().stream(_spec(side), side.Config(
            lanes=lanes, chunk=chunk, max_queue=256,
            clock=side.Clock(tick=0.5)))
        reqs = [g for g in pool(side) for _ in range(dups)]
        random.Random(seed).shuffle(reqs)
        tickets = [stream.submit(g) for g in reqs]
        stream.drain()
        return tickets, stream

    want, (tickets, stream) = both(run)
    assert_same_streams((tickets, stream), want)
    # no request lost or duplicated, refill only at chunk boundaries, no
    # starvation (residency bounded by the solo iteration count)
    assert len({tk.seq for tk in tickets}) == len(tickets)
    assert stream.counters["done"] == len(tickets) and stream.idle
    for tk in tickets:
        assert 1 <= tk.admit_round <= tk.drain_round <= stream.round
        assert 1 <= tk.chunks <= tk.result.iterations
    assert_port_matches_solo(_spec(PORT), tickets)


@pytest.mark.parametrize("bound,seed", [(1, 0), (2, 3), (4, 11)])
def test_stream_queue_never_exceeds_bound(bound, seed):
    def run(side):
        stream = side.session().stream(_spec(side), side.Config(
            lanes=1, chunk=1, max_queue=bound, clock=side.Clock(tick=1.0)))
        rng = random.Random(seed)
        tickets, lens = [], []
        for _ in range(3 * bound + 4):
            tickets.append(stream.submit(rng.choice(pool(side))))
            lens.append(stream.queue_len)
            if rng.random() < 0.3:
                stream.pump()
                lens.append(stream.queue_len)
        stream.drain()
        return tickets, stream, lens

    want, got = both(run)
    assert got[2] == want[2] and max(got[2]) <= bound
    assert_same_streams(got[:2], want[:2])
    tickets = got[0]
    assert got[1].queue_len == 0
    assert all(tk.status in ("done", "rejected") for tk in tickets)
    assert all(tk.reason for tk in tickets if tk.status == "rejected")


# ---------------------------------------------------------------------------
# latency accounting (fake clock) and overload
# ---------------------------------------------------------------------------

def test_stream_latency_stamps_monotone_and_additive():
    def run(side):
        stream = side.session().stream(_spec(side), side.Config(
            lanes=2, chunk=2, clock=side.Clock(start=10.0, tick=0.25)))
        tickets = [stream.submit(g) for g in pool(side)]
        stream.drain()
        return tickets, stream

    want, got = both(run)
    assert_same_streams(got, want)
    for tk in got[0]:
        assert tk.enqueue_s <= tk.admit_s <= tk.drain_s
        assert tk.queue_seconds + tk.service_seconds == \
            pytest.approx(tk.total_seconds)
        assert tk.result.host_dispatches == tk.chunks


def test_stream_overload_rejects_immediately_instead_of_hanging():
    def run(side):
        stream = side.session().stream(_spec(side), side.Config(
            lanes=1, max_queue=1, clock=side.Clock(tick=1.0)))
        first = stream.submit(pool(side)[0])
        second = stream.submit(pool(side)[1])   # queue full: bounced
        before = (first.status, second.status, second.reason,
                  second.admit_s, second.drain_s)
        stream.drain()
        return [first, second], stream, before

    want, got = both(run)
    assert got[2] == want[2]
    assert got[2][:2] == ("queued", "rejected") and "queue full" in got[2][2]
    assert got[2][3:] == (None, None)
    assert_same_streams(got[:2], want[:2])
    assert got[0][0].status == "done"


def test_manual_clock_matches_reference():
    for side in (REF, PORT):
        clk = side.Clock(start=1.0, tick=0.5)
        assert (clk(), clk()) == (1.0, 1.5)
        clk.advance(2.0)
        assert clk() == 4.0
        with pytest.raises(ValueError, match="monotone"):
            clk.advance(-1.0)
        with pytest.raises(ValueError, match="tick"):
            side.Clock(tick=-0.1)


def test_stream_stats_and_report_before_any_request():
    want, got = both(lambda side: side.session().stream(
        _spec(side), side.Config(lanes=3)))
    assert stats(got) == stats(want)
    assert got.report().to_json()["extra"]["stream"]["lanes_resolved"] == 4
