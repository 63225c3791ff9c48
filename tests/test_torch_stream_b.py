"""The port's stream service against ``repro``'s, part two
(``tests/test_stream.py``'s contracts): backpressure and shed policies,
max_iter failures, the chunk policies, a bounded session, adaptive lane
width (grow, shrink, fixed), admission policies (priority, EDF with
shedding) and the threaded front end — every ticket and ``stats()`` equal
to the reference's under a ``ManualClock``."""
import random
import threading

import numpy as np
import pytest

from _torch_stream import (PORT, REF, assert_port_matches_solo,
                           assert_same_streams, both, pool)
from repro.core.worklist import bucket_capacities, pick_bucket


def _spec(side, **kw):
    return side.Spec(regime="host", **{"window": 64, **kw})


def _stream(side, *, session=None, spec=None, **cfg):
    cfg.setdefault("clock", side.Clock(tick=1.0))
    return (session or side.session()).stream(spec or _spec(side),
                                              side.Config(**cfg))


# ---------------------------------------------------------------------------
# backpressure / admission control
# ---------------------------------------------------------------------------

def test_stream_shed_oldest_bounces_the_queue_head():
    def run(side):
        stream = _stream(side, lanes=1, max_queue=2, shed="shed-oldest")
        tickets = [stream.submit(g) for g in pool(side)[:3]]
        before = [(tk.status, tk.reason) for tk in tickets]
        stream.drain()
        return tickets, stream, before

    want, got = both(run)
    assert got[2] == want[2]
    assert got[2][0][0] == "rejected" and "shed" in got[2][0][1]
    assert_same_streams(got[:2], want[:2])
    assert [tk.status for tk in got[0]] == ["rejected", "done", "done"]


def test_stream_shed_policy_hook():
    def keep_smallest(queued, incoming):
        return max((*queued, incoming), key=lambda tk: tk.n_nodes)

    def run(side):
        stream = _stream(side, lanes=1, max_queue=1, shed=keep_smallest)
        big = max(pool(side), key=lambda g: g.n_nodes)
        small = min(pool(side), key=lambda g: g.n_nodes)
        tickets = [stream.submit(big), stream.submit(small)]
        stream.drain()
        return tickets, stream

    want, got = both(run)
    assert_same_streams(got, want)
    assert [tk.status for tk in got[0]] == ["rejected", "done"]
    bad = _stream(PORT, lanes=1, max_queue=1,
                  shed=lambda queued, incoming: object())
    bad.submit(pool(PORT)[0])
    with pytest.raises(ValueError, match="shed policy"):
        bad.submit(pool(PORT)[1])


def test_stream_rejects_oversized_requests():
    def run(side):
        g = max(pool(side), key=lambda g: g.n_nodes)
        stream = _stream(side, max_nodes=g.n_nodes - 1)
        return [stream.submit(g)], stream

    want, got = both(run)
    assert_same_streams(got, want)
    assert got[0][0].status == "rejected" and "max_nodes" in \
        got[0][0].reason


def test_stream_max_iter_exhaustion_fails_the_ticket_not_the_service():
    host = _spec(PORT)
    iters = {id(g): PORT.session().run(host, g).iterations
             for g in pool(PORT)}
    i_bad = max(range(len(pool(PORT))), key=lambda i: iters[id(pool(PORT)[i])])
    i_good = min(range(len(pool(PORT))),
                 key=lambda i: iters[id(pool(PORT)[i])])
    cap = iters[id(pool(PORT)[i_bad])] - 1

    def run(side):
        stream = _stream(side, spec=_spec(side, max_iter=cap), lanes=2,
                         chunk=2)
        tickets = [stream.submit(pool(side)[i_bad]),
                   stream.submit(pool(side)[i_good])]
        stream.drain()
        with pytest.raises(RuntimeError, match="failed"):
            stream.run([pool(side)[i_bad]])
        return tickets, stream

    want, got = both(run)
    assert_same_streams(got, want)
    bad, good = got[0]
    assert bad.status == "failed" and "max_iter" in bad.reason
    assert bad.result is None and good.status == "done"


def test_chunk_policy_knob_resolution():
    for pol in (REF.policy, PORT.policy):
        assert isinstance(pol.make_chunk_policy(4), pol.FixedChunk)
        assert pol.make_chunk_policy(4)() == 4
        assert isinstance(pol.make_chunk_policy("auto"), pol.AdaptiveChunk)
        ad = pol.AdaptiveChunk(min_iters=2, max_iters=16, iters=4)
        assert pol.make_chunk_policy(ad) is ad
        seen = []
        for drained, resident in ((0, 3), (2, 3), (0, 3), (0, 3), (0, 3),
                                  (3, 3), (1, 4), (0, 0)):
            ad.observe_round(drained, resident, 4)
            seen.append(ad())
        if pol is REF.policy:
            want = seen
        assert seen == want == [8, 4, 8, 16, 16, 8, 8, 8]
        with pytest.raises(ValueError, match=">= 1"):
            pol.make_chunk_policy(0)
        with pytest.raises(TypeError, match="chunk"):
            pol.make_chunk_policy(True)
        with pytest.raises(TypeError, match="chunk"):
            pol.make_chunk_policy("fast")


def test_bounded_session_streams_without_evicting_live_entries():
    # a tiny bound forces evictions mid-stream; results stay equal because
    # a pump round pins its own entries and the lane groups own their
    # device state (the port keeps one prep entry per distinct request, so
    # a bound of 3 is exceeded by the pool's 6)
    sess = PORT.session(max_entries=3)

    def run(side):
        stream = _stream(side, session=sess if side is PORT else None,
                         lanes=2, chunk=2)
        tickets = [stream.submit(g) for g in pool(side)]
        stream.drain()
        return tickets, stream

    want, got = both(run)
    assert_same_streams(got, want)
    assert sess.stats.evictions > 0 and len(sess.cache) <= 3
    assert_port_matches_solo(_spec(PORT), got[0])


def test_default_session_stream_entry_point():
    from repro_torch.exec import default_session, reset_default_session
    from repro_torch.serve import StreamSession
    reset_default_session()
    try:
        stream = default_session("cpu").stream(_spec(PORT))
        assert isinstance(stream, StreamSession)
        res = stream.run(pool(PORT)[:2])
        want = REF.session().stream(_spec(REF)).run(pool(REF)[:2])
        for r, w in zip(res, want):
            np.testing.assert_array_equal(r.colors, w.colors)
    finally:
        reset_default_session()


def test_heavy_tail_batch_covers_multiple_rungs():
    from repro_torch.graphs import get_dataset_batch
    gs = get_dataset_batch(heavy_tail=16, seed=7)
    assert len(gs) == 16
    caps = bucket_capacities(1 << 20, ratio=2)
    assert len({pick_bucket(caps, g.n_nodes) for g in gs}) >= 2
    # popular repeated cells collapse onto shared Graph objects
    assert len({id(g) for g in gs}) < len(gs)
    again = get_dataset_batch(heavy_tail=16, seed=7)
    assert [g.n_nodes for g in gs] == [g.n_nodes for g in again]


# ---------------------------------------------------------------------------
# adaptive lane width: demand growth, shrink-on-idle
# ---------------------------------------------------------------------------

def test_two_resident_rung_runs_at_b2_not_configured_width():
    def run(side):
        stream = _stream(side, lanes=8, chunk=1)
        tickets = [stream.submit(g) for g in pool(side)[:2]]
        stream.pump()
        (grp,) = stream._groups.values()
        shape = (grp.b, grp.b_max, grp.resident)
        stream.drain()
        return tickets, stream, shape

    want, got = both(run)
    assert got[2] == want[2] == (2, 8, 2)
    assert_same_streams(got[:2], want[:2])
    (grp,) = got[1]._groups.values()
    assert grp.state.b == grp.b


def test_adaptive_group_grows_and_shrinks_with_demand():
    caps = bucket_capacities(1 << 20)
    rungs = [pick_bucket(caps, g.n_nodes) for g in pool(PORT)]
    rung = max(set(rungs), key=rungs.count)
    members = [i for i, r in enumerate(rungs) if r == rung]
    iters = {i: PORT.session().run(_spec(PORT), pool(PORT)[i]).iterations
             for i in members}
    slow = max(members, key=iters.get)
    rest = [i for i in members if i != slow] or [slow]

    def run(side):
        stream = _stream(side, lanes=8, chunk=1, shrink_after=1)
        tickets = [stream.submit(pool(side)[slow])]
        stream.pump()                       # slow resident alone at b=1
        tickets += [stream.submit(pool(side)[rest[k % len(rest)]])
                    for k in range(4)]
        stream.pump()                       # queue pressure: grow
        (grp,) = stream._groups.values()
        grown = (grp.grows, grp.b)
        stream.drain()                      # tail rounds: shrink
        return tickets, stream, grown

    want, got = both(run)
    assert got[2] == want[2] and got[2][0] >= 1 and got[2][1] >= 2
    (grp,) = got[1]._groups.values()
    assert grp.shrinks >= 1 and grp.state.b == grp.b <= grp.max_b
    assert_same_streams(got[:2], want[:2])
    assert_port_matches_solo(_spec(PORT), got[0])


def test_fixed_mode_keeps_configured_width():
    def run(side):
        stream = _stream(side, lanes=4, adaptive_lanes=False)
        tickets = [stream.submit(pool(side)[0])]
        stream.drain()
        return tickets, stream

    want, got = both(run)
    assert_same_streams(got, want)
    (grp,) = got[1]._groups.values()
    assert (grp.b, grp.state.b, grp.grows, grp.shrinks) == (4, 4, 0, 0)


@pytest.mark.parametrize("seed,lanes,chunk", [(0, 2, 1), (5, 4, 2),
                                              (9, 8, 3)])
def test_stream_invariants_across_grow_shrink(seed, lanes, chunk):
    def run(side):
        stream = _stream(side, lanes=lanes, chunk=chunk, shrink_after=1,
                         max_queue=256)
        rng = random.Random(seed)
        reqs = [g for g in pool(side) for _ in range(2)]
        rng.shuffle(reqs)
        tickets = []
        for g in reqs:
            tickets.append(stream.submit(g))
            if rng.random() < 0.5:
                stream.pump()
        stream.drain()
        return tickets, stream

    want, got = both(run)
    assert_same_streams(got, want)
    tickets, stream = got
    assert all(tk.status == "done" for tk in tickets) and stream.idle
    assert sum(g.grows for g in stream._groups.values()) >= 1
    assert sum(g.shrinks for g in stream._groups.values()) >= 1
    for tk in tickets:
        assert 1 <= tk.admit_round <= tk.drain_round <= stream.round
        assert 1 <= tk.chunks <= tk.result.iterations


def test_stream_lanes_validated_and_surfaced():
    for bad in (0, -1, True, 2.5, "8"):
        with pytest.raises(ValueError, match="lanes"):
            PORT.Config(lanes=bad)
    with pytest.raises(ValueError, match="shrink_after"):
        PORT.Config(shrink_after=0)
    assert PORT.Config(lanes=3).lanes_resolved == 4
    stream = _stream(PORT, lanes=3)
    assert stream.stats()["lanes_resolved"] == 4
    assert stream.report().extra["stream"]["lanes_resolved"] == 4


# ---------------------------------------------------------------------------
# admission policies: priority classes, EDF + shed-on-hopeless
# ---------------------------------------------------------------------------

def test_stream_priority_admission_orders_by_class():
    def run(side):
        stream = _stream(side, lanes=1, chunk=1, admission="priority")
        lo = stream.submit(pool(side)[0], priority=0)
        hi = stream.submit(pool(side)[1], priority=5)
        stream.pump()
        first = (hi.admit_round, lo.status)
        stream.drain()
        return [lo, hi], stream, first

    want, got = both(run)
    assert got[2] == want[2] == (1, "queued")
    assert_same_streams(got[:2], want[:2])
    lo, hi = got[0]
    assert lo.admit_round > hi.admit_round


def test_stream_edf_orders_by_deadline():
    def run(side):
        stream = _stream(side, lanes=1, chunk=1, admission="edf",
                         clock=side.Clock(start=0.0, tick=0.5))
        tickets = [stream.submit(pool(side)[0], deadline_s=1e6),
                   stream.submit(pool(side)[1], deadline_s=10.0),
                   stream.submit(pool(side)[4])]
        stream.drain()
        return tickets, stream

    want, got = both(run)
    assert_same_streams(got, want)
    loose, tight, free = got[0]
    assert tight.admit_round < loose.admit_round < free.admit_round


def test_stream_edf_sheds_hopeless_tickets_with_reason():
    def run(side):
        stream = _stream(side, lanes=1, chunk=64, admission="edf",
                         clock=side.Clock(start=0.0, tick=1.0))
        g = pool(side)[0]
        tickets = [stream.submit(g, deadline_s=1e9)]
        stream.drain()                  # observes the rung's service time
        tickets.append(stream.submit(g, deadline_s=0.0))
        stream.pump()
        tickets.append(stream.submit(g, deadline_s=1e9))
        stream.drain()
        return tickets, stream

    want, got = both(run)
    assert_same_streams(got, want)
    warm, hopeless, feasible = got[0]
    stream = got[1]
    assert warm.deadline_met is True and feasible.deadline_met is True
    assert hopeless.status == "rejected" and "deadline" in hopeless.reason
    assert hopeless.reason == want[0][1].reason
    assert stream.counters["shed_deadline"] == 1
    assert stream.metrics.get("stream.outcome")["shed_deadline"] == 1
    assert stream.metrics.get("stream.deadline_slack").count == 2
    assert stream.metrics.as_dict() == want[1].metrics.as_dict()


def test_stream_edf_never_sheds_without_observations():
    def run(side):
        stream = _stream(side, lanes=1, admission="edf")
        tickets = [stream.submit(pool(side)[0], deadline_s=0.0)]
        stream.drain()
        return tickets, stream

    want, got = both(run)
    assert_same_streams(got, want)
    assert got[0][0].status == "done" and got[0][0].deadline_met is False


def test_admission_policy_order_must_be_permutation():
    class Bad:
        def order(self, queued, clock):
            return list(queued)[:-1]

        def hopeless(self, ticket, clock, estimate):
            return None

    stream = _stream(PORT, admission=Bad())
    stream.submit(pool(PORT)[0])
    stream.submit(pool(PORT)[1])
    with pytest.raises(ValueError, match="permutation"):
        stream.pump()
    for pol in (REF.policy, PORT.policy):
        with pytest.raises(ValueError, match="unknown admission"):
            pol.make_admission_policy("lifo")
        with pytest.raises(TypeError, match="admission"):
            pol.make_admission_policy(3)


def test_stream_shed_callable_raising_rejects_with_reason():
    def boom(queued, incoming):
        raise RuntimeError("kaboom")

    def run(side):
        stream = _stream(side, lanes=1, max_queue=1, shed=boom)
        tickets = [stream.submit(g) for g in pool(side)[:2]]
        before = [(tk.status, tk.reason) for tk in tickets]
        stream.drain()
        return tickets, stream, before

    want, got = both(run)
    assert got[2] == want[2]
    assert got[2][1][0] == "rejected" and "kaboom" in got[2][1][1]
    assert_same_streams(got[:2], want[:2])
    assert got[0][0].status == "done"


# ---------------------------------------------------------------------------
# async front-end: producer threads overlap the pump thread
# ---------------------------------------------------------------------------

def test_stream_serving_overlaps_producers_with_pump_thread():
    stream = PORT.session().stream(_spec(PORT),
                                   PORT.Config(lanes=4, max_queue=256))
    tickets: list = []

    def produce():
        for g in pool(PORT):
            tickets.append(stream.submit(g))

    with stream.serving():
        threads = [threading.Thread(target=produce) for _ in range(2)]
        for th in threads:
            th.start()
        extra = stream.submit(pool(PORT)[0])
        for th in threads:
            th.join()
        assert extra.wait(timeout=300)
    assert stream.idle
    assert len({tk.seq for tk in tickets}) == 2 * len(pool(PORT))
    assert_port_matches_solo(_spec(PORT), tickets + [extra])
    with pytest.raises(RuntimeError, match="serving"):
        with stream.serving():
            stream.run(pool(PORT)[:1])
    # the threaded run's results equal the reference's synchronous ones
    want = REF.session().stream(_spec(REF)).run(pool(REF))
    got = {id(tk.graph): tk.result for tk in tickets}
    for g, w in zip(pool(PORT), want):
        np.testing.assert_array_equal(got[id(g)].colors, w.colors)
        assert got[id(g)].mode_trace == w.mode_trace


def test_stream_pump_failure_surfaces_from_serving():
    """An exception on the pump thread is re-raised at the serving exit,
    after the thread stops (a failed capture on the card arrives so)."""
    stream = PORT.session().stream(_spec(PORT), PORT.Config(lanes=1))

    class Broken(Exception):
        pass

    def fail(*a, **k):
        raise Broken("pump")

    stream._admit = fail
    with pytest.raises(Broken, match="pump"):
        with stream.serving():
            stream.submit(pool(PORT)[0])
    assert not stream._serving
