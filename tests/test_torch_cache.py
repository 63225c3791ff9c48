"""The session cache against ``repro``'s contracts (``tests/test_exec.py``):
the distributed Pipe's partition and steps are keyed by the graph's
content, so an equal graph rebuilt per request is a warm hit, while a
relabeled graph with the same name and sizes is a miss; the prepared
graphs are keyed by identity and shared by the host and outlined
regimes; ``color_distributed(steps_cache=)`` makes the dict a session's
backing store."""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.exec import ExecutionSpec, Session
from repro_torch.exec.session import _content_key
from repro_torch.graphs import get_dataset

# the test workers share the machine's cores: no intra-op thread pool
torch.set_num_threads(1)


def _same_result(a, b):
    np.testing.assert_array_equal(a.colors, b.colors)
    assert (a.iterations, a.n_colors, a.mode_trace, a.counts,
            a.host_dispatches) == (b.iterations, b.n_colors, b.mode_trace,
                                   b.counts, b.host_dispatches)


def _dist(g, cache):
    return repro_torch.color_distributed(g, n_shards=1, device="cpu",
                                        steps_cache=cache)


def test_legacy_steps_cache_still_accepted_and_reused():
    g = get_dataset("europe_osm_s", scale=0.02)
    cache: dict = {}
    a = _dist(g, cache)
    assert len(cache) > 0                 # the dict IS the session store
    n_entries = len(cache)
    b = _dist(g, cache)
    assert len(cache) == n_entries        # warm: no new entries
    _same_result(a, b)
    repro_torch.verify_coloring(g, a.colors)


def test_dist_cache_keys_by_content_like_legacy_steps_cache():
    """A caller that rebuilds an equal graph per request still reuses the
    partitioned graph and the steps."""
    a = get_dataset("europe_osm_s", scale=0.01)
    b = dataclasses.replace(a)            # equal content, distinct object
    s = Session("cpu")
    spec = ExecutionSpec(regime="dist", n_shards=1)
    r_a = s.run(spec, a)
    n_entries, misses = len(s.cache), s.stats.misses
    r_b = s.run(spec, b)
    assert len(s.cache) == n_entries and s.stats.misses == misses
    assert s.stats.hits >= 2              # the partition and the steps
    _same_result(r_a, r_b)
    cache: dict = {}
    _dist(a, cache)
    n_entries = len(cache)
    _dist(b, cache)
    assert len(cache) == n_entries


@pytest.mark.parametrize("n_shards", [1, 2])
def test_relabeled_graph_with_the_same_name_and_sizes_is_a_miss(n_shards):
    """A shuffled europe_osm_s keeps the name and sizes of the plain one
    but not its labels: it must not reuse the plain one's partition or
    steps, and both colorings stay valid whatever runs first."""
    plain = get_dataset("europe_osm_s", scale=0.02, layout="ell-tail",
                        ell_cap=128)
    shuffled = dataclasses.replace(
        get_dataset("europe_osm_s", scale=0.02, layout="ell-tail",
                    ell_cap=128, reorder="shuffle"), name=plain.name)
    assert (shuffled.name, shuffled.n_nodes, shuffled.n_edges) == \
        (plain.name, plain.n_nodes, plain.n_edges)
    assert _content_key(shuffled) != _content_key(plain)
    cache: dict = {}
    for g in (shuffled, plain):
        n_entries = len(cache)
        r = repro_torch.color_distributed(g, n_shards=n_shards,
                                          device="cpu", steps_cache=cache)
        assert len(cache) == n_entries + 2    # partition and steps: misses
        repro_torch.verify_coloring(g, r.colors)


def test_content_key_is_memoised_per_graph_and_follows_the_plan():
    a = get_dataset("kron_g500-logn21_s", scale=0.02, layout="ell-tail")
    assert _content_key(a) is _content_key(a)
    b = dataclasses.replace(a)
    assert _content_key(b) == _content_key(a)
    other = get_dataset("kron_g500-logn21_s", scale=0.02, layout="pure-ell")
    assert _content_key(other) != _content_key(a)   # the layout plan


def test_session_respects_graph_identity_not_name():
    """The prep entries stay keyed by identity, as in the reference."""
    a = get_dataset("europe_osm_s", scale=0.01)
    b = dataclasses.replace(a)
    for regime in ("host", "outlined"):
        s = Session("cpu")
        spec = ExecutionSpec(regime=regime)
        s.run(spec, a)
        misses = s.stats.misses
        s.run(spec, b)
        assert s.stats.misses > misses


def test_prepare_cache_is_shared_across_host_and_outlined():
    g = get_dataset("europe_osm_s", scale=0.02)
    s = Session("cpu")
    a = s.run(ExecutionSpec(regime="host"), g)
    misses, hits = s.stats.misses, s.stats.hits
    b = s.run(ExecutionSpec(regime="outlined"), g)   # same prepared graph
    assert s.stats.misses == misses
    assert s.stats.hits == hits + 1
    np.testing.assert_array_equal(a.colors, b.colors)


def test_session_takes_its_cache_dict():
    cache: dict = {}
    s = Session("cpu", cache=cache)
    s.run(ExecutionSpec(), get_dataset("europe_osm_s", scale=0.01))
    assert s.cache is cache and len(cache) == 1


def test_steps_cache_and_session_do_not_mix():
    g = get_dataset("europe_osm_s", scale=0.01)
    with pytest.raises(ValueError, match="steps_cache"):
        repro_torch.color_distributed(g, n_shards=1, device="cpu",
                                      steps_cache={},
                                      session=Session("cpu"))
