"""On-device sampler distribution tests (SamplerTables draws run under jit
on the CPU test backend; same code path as the GPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from smore_tpu.sampling.tables import SamplerTables


@pytest.fixture
def tables(toy_graph):
    return SamplerTables.build(toy_graph)


def test_source_sample_distribution(toy_graph, tables):
    g = toy_graph
    key = jax.random.PRNGKey(0)
    draws = np.asarray(tables.source_sample(key, (100_000,)))
    emp = np.bincount(draws, minlength=g.n_vertices) / len(draws)
    w = g.out_degree**0.75  # POWER_SAMPLE quirk: vertex table is ^0.75 too
    expect = w / w.sum()
    np.testing.assert_allclose(emp, expect, atol=0.01)


def test_negative_sample_distribution(toy_graph, tables):
    g = toy_graph
    key = jax.random.PRNGKey(1)
    draws = np.asarray(tables.negative_sample(key, (100_000,)))
    emp = np.bincount(draws, minlength=g.n_vertices) / len(draws)
    w = (g.out_degree + g.in_degree) ** 0.75
    expect = w / w.sum()
    np.testing.assert_allclose(emp, expect, atol=0.01)


def test_target_sample_per_vertex(toy_graph, tables):
    g = toy_graph
    a = g.name2id["userA"]
    key = jax.random.PRNGKey(2)
    vids = jnp.full((100_000,), a, dtype=jnp.int32)
    draws = np.asarray(tables.target_sample(key, vids))
    emp = np.bincount(draws, minlength=g.n_vertices) / len(draws)
    # userA -> itemA (w=3), itemC (w=5), each ^0.75-normalized in-segment
    w = np.zeros(g.n_vertices)
    w[g.name2id["itemA"]] = 3.0**0.75
    w[g.name2id["itemC"]] = 5.0**0.75
    expect = w / w.sum()
    np.testing.assert_allclose(emp, expect, atol=0.01)


def test_target_sample_zero_degree_returns_self():
    from smore_tpu.graph.graph import Graph

    g = Graph.from_edges([("a", "b", 1.0)], undirected=False)
    t = SamplerTables.build(g, vertex_method="no_degrees")
    b = g.name2id["b"]
    out = np.asarray(
        t.target_sample(jax.random.PRNGKey(0), jnp.full((64,), b, jnp.int32))
    )
    assert (out == b).all()


def test_draws_jit_and_scan_safe(tables):
    """Sampler must be traceable inside jit+scan (the training hot path)."""

    @jax.jit
    def run(key):
        def body(key, _):
            key, sub = jax.random.split(key)
            k1, k2 = jax.random.split(sub)
            src = tables.source_sample(k1, (16,))
            pos = tables.target_sample(k2, src)
            return key, (src, pos)

        _, (srcs, poss) = jax.lax.scan(body, key, None, length=4)
        return srcs, poss

    srcs, poss = run(jax.random.PRNGKey(0))
    assert srcs.shape == (4, 16)
    assert poss.shape == (4, 16)


def test_edge_sample_joint_distribution(toy_graph, tables):
    """edge_sample must match the two-stage law P(src) * P(pos|src):
    P(src) prop out_degree^0.75, P(pos|src) prop edge_weight^0.75."""
    g = toy_graph
    assert tables.has_edge_table
    key = jax.random.PRNGKey(3)
    src, pos = tables.edge_sample(key, (200_000,))
    src, pos = np.asarray(src), np.asarray(pos)

    vmass = g.out_degree**0.75
    p_src = vmass / vmass.sum()
    seg = np.repeat(np.arange(g.n_vertices), np.diff(g.indptr))
    w75 = g.weights**0.75
    z = np.bincount(seg, weights=w75, minlength=g.n_vertices)
    expect = p_src[seg] * w75 / z[seg]  # per edge slot

    flat = {}
    for e in range(g.n_edges):
        flat[(seg[e], g.indices[e])] = flat.get((seg[e], g.indices[e]), 0) + expect[e]
    emp = {}
    for s, p in zip(src, pos):
        emp[(s, p)] = emp.get((s, p), 0) + 1.0 / len(src)
    for k, v in flat.items():
        assert abs(emp.get(k, 0.0) - v) < 0.01, (k, emp.get(k, 0.0), v)


def test_edge_sample_matches_two_stage_marginals(toy_graph, tables):
    """Source marginal of the joint draw == source_sample distribution."""
    key = jax.random.PRNGKey(4)
    src_joint, _ = tables.edge_sample(key, (150_000,))
    src_two = tables.source_sample(jax.random.PRNGKey(5), (150_000,))
    n = toy_graph.n_vertices
    e1 = np.bincount(np.asarray(src_joint), minlength=n) / 150_000
    e2 = np.bincount(np.asarray(src_two), minlength=n) / 150_000
    np.testing.assert_allclose(e1, e2, atol=0.012)


def test_grouped_edge_batch_joint_law(toy_graph, tables):
    """draw_edge_batch_grouped must preserve the per-sample (src, pos)
    joint law of the ungrouped edge draw (sources repeat G times, each
    with an independent conditional context)."""
    import jax

    G, B = 4, 40_000
    src, pos, negs = tables.draw_edge_batch_grouped(
        jax.random.PRNGKey(6), B, G, 16
    )
    src, pos = np.asarray(src), np.asarray(pos)
    assert src.shape == (B,) and pos.shape == (B,)
    assert (src.reshape(-1, G) == src.reshape(-1, G)[:, :1]).all()  # layout

    g = toy_graph
    vmass = g.out_degree**0.75
    p_src = vmass / vmass.sum()
    seg = np.repeat(np.arange(g.n_vertices), np.diff(g.indptr))
    w75 = g.weights**0.75
    z = np.bincount(seg, weights=w75, minlength=g.n_vertices)
    expect = {}
    for e in range(g.n_edges):
        k = (seg[e], g.indices[e])
        expect[k] = expect.get(k, 0.0) + p_src[seg[e]] * w75[e] / z[seg[e]]
    emp = {}
    for s, p in zip(src, pos):
        emp[(s, p)] = emp.get((s, p), 0) + 1.0 / B
    for k, v in expect.items():
        assert abs(emp.get(k, 0.0) - v) < 0.015, (k, emp.get(k, 0.0), v)
