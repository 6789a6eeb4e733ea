"""Band-stratified sampling + banded SGNS step (the large-table fast
path, smore_tpu/sampling/banded.py + ops.update.sgns_shared_negs_step_banded).

Covers: (1) the stratified draw reproduces the exact joint edge law (1D
and 2D strata), (2) the banded step computes the same update as the
regular shared-negs step given identical indices (incl. the 2D
source-banded routing), (3) LINE trained banded learns the same
structure as unbanded."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from smore_tpu.graph.graph import Graph
from smore_tpu.models.line import LINE
from smore_tpu.ops.update import (
    sgns_shared_negs_step,
    sgns_shared_negs_step_banded,
)
from smore_tpu.sampling.banded import BandedTables
from smore_tpu.sampling.tables import SamplerTables

BAND = 64


@pytest.fixture(scope="module")
def comm_graph():
    """200-vertex 4-community graph with weighted edges."""
    rng = np.random.default_rng(3)
    edges = []
    for _ in range(3000):
        c = rng.integers(0, 4)
        if rng.random() < 0.9:
            a, b = rng.integers(0, 50, 2) + 50 * c
        else:
            a, b = rng.integers(0, 200, 2)
        if a != b:
            edges.append((f"v{a}", f"v{b}", float(rng.integers(1, 4))))
    return Graph.from_edges(edges, undirected=True)


def _joint_law(g, vertex_method="out_degrees", power=0.75):
    """Exact P(src, dst) over edge slots (tables.py edge_pa law)."""
    from smore_tpu.sampling.tables import _vertex_distribution

    src = np.repeat(np.arange(g.n_vertices), np.diff(g.indptr))
    vmass = _vertex_distribution(g, vertex_method).astype(np.float64)
    vmass = np.where(vmass > 0, vmass**power, 0.0)
    w = np.asarray(g.weights, dtype=np.float64) ** power
    z = np.zeros(g.n_vertices)
    np.add.at(z, src, w)
    jw = (vmass[src] / vmass.sum()) * (w / z[src])
    return src, np.asarray(g.indices), jw


@pytest.mark.parametrize("two_d,group", [(False, 1), (False, 4),
                                         (True, 1), (True, 4)])
def test_banded_draw_matches_joint_edge_law(comm_graph, two_d, group):
    """The stratified law decomposes as P(stratum) * P(src, pos |
    stratum); each factor is tested at its own statistical resolution
    (a joint pair-TV test would be floored by stratum-assignment noise:
    all B draws of a step share ONE stratum, so that dimension only gets
    `reps` samples)."""
    g = comm_graph
    bt = BandedTables.build(g, band_size=BAND, two_d=two_d)
    nb = -(-g.n_vertices // BAND)
    assert bt.n_bands == nb

    src_ref, dst_ref, jw = _joint_law(g)
    strat_ref = (src_ref // BAND) * nb + dst_ref // BAND if two_d else (
        dst_ref // BAND)
    n_strata = nb * nb if two_d else nb
    strat_p = np.zeros(n_strata)
    np.add.at(strat_p, strat_ref, jw)
    pair_p = np.zeros((g.n_vertices, g.n_vertices))
    np.add.at(pair_p, (src_ref, dst_ref), jw)

    B, reps = 4096, 150
    counts = {}
    strat_n = np.zeros(n_strata)

    @jax.jit
    def draw(key):
        return bt.draw_banded_batch(key, B, group, 8)

    for r in range(reps):
        sb, db, src, pos, negs = draw(jax.random.PRNGKey(r))
        src, pos = np.asarray(src), np.asarray(pos)
        s = (int(sb) // BAND) * nb + int(db) // BAND if two_d else (
            int(db) // BAND)
        strat_n[s] += 1
        # every positive inside the dst band; 2D: every src in its band
        assert ((pos >= int(db)) & (pos < int(db) + BAND)).all()
        if two_d:
            assert ((src >= int(sb)) & (src < int(sb) + BAND)).all()
        if s not in counts:
            counts[s] = np.zeros((g.n_vertices, g.n_vertices))
        np.add.at(counts[s], (src, pos), 1.0)

    # stratum marginal: frequencies within 4 sigma of expectation
    emp_s = strat_n / reps
    sd = np.sqrt(strat_p * (1 - strat_p) / reps)
    assert (np.abs(emp_s - strat_p) < 4 * sd + 1e-12).all()

    # conditional law inside the most-sampled stratum: tight TV bound
    s = int(strat_n.argmax())
    cond = pair_p * 0.0
    sel = strat_ref == s
    np.add.at(cond, (src_ref[sel], dst_ref[sel]), jw[sel])
    cond /= cond.sum()
    emp = counts[s] / counts[s].sum()
    tv = 0.5 * np.abs(emp - cond).sum()
    assert tv < 0.05, f"conditional TV {tv:.4f} in stratum {s}"


def test_banded_negatives_keep_global_law(comm_graph):
    g = comm_graph
    bt = BandedTables.build(g, band_size=BAND)
    deg = (g.out_degree + g.in_degree).astype(np.float64) ** 0.75
    want = deg / deg.sum()
    counts = np.zeros(g.n_vertices)

    @jax.jit
    def draw(key):
        return bt.draw_banded_batch(key, 256, 1, 2048)[4]

    for r in range(60):
        counts += np.bincount(np.asarray(draw(jax.random.PRNGKey(r))),
                              minlength=g.n_vertices)
    emp = counts / counts.sum()
    assert 0.5 * np.abs(emp - want).sum() < 0.05


@pytest.mark.parametrize("shared,group,src_banded",
                         [(False, 1, False), (False, 4, False),
                          (True, 4, False),
                          (False, 1, True), (False, 4, True)])
def test_banded_step_equals_regular_step(comm_graph, shared, group,
                                         src_banded):
    """Same (src, pos, negs) through both steps -> same tables."""
    g = comm_graph
    n_pad = -(-g.n_vertices // BAND) * BAND
    key = jax.random.PRNGKey(0)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    wv = jax.random.normal(k1, (n_pad, 8)) * 0.1
    wc = jax.random.normal(k2, (n_pad, 8)) * 0.1
    B, Ks = 64, 16
    db = jnp.int32(2 * BAND)
    sb = jnp.int32(1 * BAND)
    lo, hi = (BAND, 2 * BAND) if src_banded else (0, g.n_vertices)
    src_small = jax.random.randint(k3, (B // group,), lo, hi)
    src = jnp.repeat(src_small, group)
    pos = jax.random.randint(k4, (B,), 2 * BAND, 3 * BAND)  # inside band
    negs = jax.random.randint(jax.random.fold_in(key, 9), (Ks,), 0,
                              g.n_vertices)
    alpha = jnp.float32(0.05)

    if shared:
        ref, _, _ = sgns_shared_negs_step(
            wv, wv, src, pos, negs, alpha, shared_table=True,
            src_group=group,
        )
        got, got2, _ = sgns_shared_negs_step_banded(
            wv, wv, db, BAND, src, pos, negs, alpha,
            shared_table=True, src_group=group,
        )
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=1e-5, atol=1e-7)
        assert got is got2
    else:
        rv, rc, _ = sgns_shared_negs_step(
            wv, wc, src, pos, negs, alpha, src_group=group
        )
        gv, gc, _ = sgns_shared_negs_step_banded(
            wv, wc, db, BAND, src, pos, negs, alpha, src_group=group,
            src_band_start=sb if src_banded else None,
        )
        np.testing.assert_allclose(np.asarray(gv), np.asarray(rv),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(np.asarray(gc), np.asarray(rc),
                                   rtol=1e-5, atol=1e-7)


def _auc(m, g, rng):
    wv = np.asarray(m.state["vertex"])
    wv = wv / (np.linalg.norm(wv, axis=1, keepdims=True) + 1e-9)
    src = np.repeat(np.arange(g.n_vertices), np.diff(g.indptr))
    pos_s = (wv[src] * wv[g.indices]).sum(1)
    a = rng.integers(0, g.n_vertices, len(src))
    b = rng.integers(0, g.n_vertices, len(src))
    neg_s = (wv[a] * wv[b]).sum(1)
    return (pos_s[:, None] > neg_s[None, : 500]).mean()


@pytest.mark.parametrize("order", [1, 2])
def test_line_banded_e2e_quality(comm_graph, order):
    g = comm_graph
    kw = dict(sample_times=0.3, negative_samples=5, alpha=0.025,
              batch=128, group=4, steps_per_call=64, verbose=False)
    m = LINE(g, seed=0)
    m.init(dim=16, order=order)
    m.train(banded=True, band_size=BAND, **kw)
    assert m.state["vertex"].shape == (g.n_vertices, 16)  # unpadded back
    assert np.isfinite(np.asarray(m.state["vertex"])).all()
    assert m.banded_tables.two_d == (order == 2)
    rng = np.random.default_rng(0)
    auc_banded = _auc(m, g, rng)

    m2 = LINE(g, seed=0)
    m2.init(dim=16, order=order)
    m2.train(banded=False, **kw)
    auc_plain = _auc(m2, g, np.random.default_rng(0))
    assert auc_banded > 0.8
    assert abs(auc_banded - auc_plain) < 0.08, (auc_banded, auc_plain)


def test_banded_auto_threshold_off_for_small_graphs(comm_graph):
    """banded="auto" must stay on the regular path below the threshold."""
    m = LINE(comm_graph, seed=0)
    m.init(dim=8, order=2)
    m.train(sample_times=0.01, batch=64, group=1, steps_per_call=4,
            verbose=False)  # banded="auto" default
    assert getattr(m, "banded_tables", None) is None


@pytest.mark.parametrize("kw,want", [
    (dict(banded=False), "unbanded"),
    (dict(banded=True, band_size=BAND), "banded"),
    (dict(banded=True, band_size=BAND, band_hold=True, hoist=2),
     "banded, held band"),
])
def test_line_step_choice(comm_graph, kw, want):
    """LINE names the step it built, and the options select it."""
    m = LINE(comm_graph, seed=0)
    m.init(dim=64, order=2)
    m.train(sample_times=0.001, batch=128, group=1, shared_negatives=16,
            steps_per_call=2, verbose=False, **kw)
    assert m.step_name == want
    assert np.isfinite(np.asarray(m.state["vertex"])).all()


# ------------------------------------------------------------------ #
# Band-persistent superstep (draw_banded_block + sgns_banded_block)
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("group", [1, 4])
def test_banded_block_draw_law(comm_graph, group):
    """One stratum per block; stratum marginal + in-band constraints +
    conditional pair law inside the most-sampled stratum."""
    g = comm_graph
    bt = BandedTables.build(g, band_size=BAND, two_d=True)
    nb = bt.n_bands
    src_ref, dst_ref, jw = _joint_law(g)
    strat_ref = (src_ref // BAND) * nb + dst_ref // BAND
    n_strata = nb * nb
    strat_p = np.zeros(n_strata)
    np.add.at(strat_p, strat_ref, jw)

    B, S, reps = 1024, 4, 150
    counts = {}
    strat_n = np.zeros(n_strata)

    @jax.jit
    def draw(key):
        return bt.draw_banded_block(key, B, group, 8, S)

    for r in range(reps):
        sb, db, src, pos, negs = draw(jax.random.PRNGKey(r))
        assert src.shape == (S, B) and pos.shape == (S, B)
        assert negs.shape == (S, 8)
        src, pos = np.asarray(src), np.asarray(pos)
        s = (int(sb) // BAND) * nb + int(db) // BAND
        strat_n[s] += 1
        assert ((pos >= int(db)) & (pos < int(db) + BAND)).all()
        assert ((src >= int(sb)) & (src < int(sb) + BAND)).all()
        if s not in counts:
            counts[s] = np.zeros((g.n_vertices, g.n_vertices))
        np.add.at(counts[s], (src.ravel(), pos.ravel()), 1.0)

    emp_s = strat_n / reps
    sd = np.sqrt(strat_p * (1 - strat_p) / reps)
    assert (np.abs(emp_s - strat_p) < 4 * sd + 1e-12).all()

    s = int(strat_n.argmax())
    pair_p = np.zeros((g.n_vertices, g.n_vertices))
    sel = strat_ref == s
    np.add.at(pair_p, (src_ref[sel], dst_ref[sel]), jw[sel])
    pair_p /= pair_p.sum()
    emp = counts[s] / counts[s].sum()
    assert 0.5 * np.abs(emp - pair_p).sum() < 0.05


@pytest.mark.parametrize("group,negs_mode",
                         [(1, "in_band"), (4, "in_band"),
                          (1, "disjoint_out"), (4, "disjoint_out")])
def test_banded_block_equals_sequential_steps(comm_graph, group,
                                              negs_mode):
    """S micro-steps through sgns_banded_block == S sequential
    sgns_shared_negs_step_banded calls on identical indices.

    Exact when negatives are in-band (fresh via the scanned band carry)
    or out-of-band but disjoint across micro-steps and untouched by
    other updates (deferred application then commutes)."""
    g = comm_graph
    n_pad = -(-g.n_vertices // BAND) * BAND
    key = jax.random.PRNGKey(1)
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    D, B, Ks, S = 8, 64, 8, 3
    wv = jax.random.normal(k1, (n_pad, D)) * 0.1
    wc = jax.random.normal(k2, (n_pad, D)) * 0.1
    sb, db = jnp.int32(1 * BAND), jnp.int32(2 * BAND)
    src_small = jax.random.randint(k3, (S, B // group), BAND, 2 * BAND)
    src = jnp.repeat(src_small, group, axis=1)
    pos = jax.random.randint(k4, (S, B), 2 * BAND, 3 * BAND)
    if negs_mode == "in_band":
        negs = jax.random.randint(k5, (S, Ks), 2 * BAND, 3 * BAND)
    else:
        # disjoint out-of-band rows per micro-step: band 0 is outside
        # both active bands (sb = BAND, db = 2*BAND)
        negs = jnp.arange(S * Ks, dtype=jnp.int32).reshape(S, Ks)
        assert int(negs.max()) < BAND
    alphas = jnp.float32([0.05, 0.04, 0.03])

    from smore_tpu.ops.update import sgns_banded_block
    gv, gc, _ = sgns_banded_block(
        wv, wc, sb, db, BAND, src, pos, negs, alphas, src_group=group,
    )

    rv, rc = wv, wc
    for t in range(S):
        rv, rc, _ = sgns_shared_negs_step_banded(
            rv, rc, db, BAND, src[t], pos[t], negs[t], alphas[t],
            src_group=group, src_band_start=sb,
        )
    np.testing.assert_allclose(np.asarray(gv), np.asarray(rv),
                               rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(gc), np.asarray(rc),
                               rtol=2e-5, atol=1e-6)


def test_line_banded_block_e2e_quality(comm_graph):
    """LINE o2 with the band-persistent superstep learns the same
    structure as the per-micro-step banded path."""
    g = comm_graph
    kw = dict(sample_times=0.3, negative_samples=5, alpha=0.025,
              batch=128, group=4, steps_per_call=64, hoist=4,
              verbose=False)
    m = LINE(g, seed=0)
    m.init(dim=16, order=2)
    m.train(banded=True, band_size=BAND, band_hold=True, **kw)
    assert m.state["vertex"].shape == (g.n_vertices, 16)
    assert np.isfinite(np.asarray(m.state["vertex"])).all()
    auc_hold = _auc(m, g, np.random.default_rng(0))

    m2 = LINE(g, seed=0)
    m2.init(dim=16, order=2)
    m2.train(banded=True, band_size=BAND, band_hold=False, **kw)
    auc_per_step = _auc(m2, g, np.random.default_rng(0))
    assert auc_hold > 0.8
    assert abs(auc_hold - auc_per_step) < 0.08, (auc_hold, auc_per_step)
