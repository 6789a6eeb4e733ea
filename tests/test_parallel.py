"""Multi-device data-parallel training on the virtual 8-device CPU mesh
(conftest sets xla_force_host_platform_device_count=8)."""

import jax
import numpy as np
import pytest

from smore_tpu.graph.graph import Graph
from smore_tpu.models.deepwalk import DeepWalk
from smore_tpu.models.line import LINE
from smore_tpu.parallel.mesh import make_mesh


pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs multiple (virtual) devices"
)


@pytest.fixture(scope="module")
def comm_graph():
    rng = np.random.default_rng(7)
    edges = []
    for base in (0, 12):
        for i in range(12):
            for j in range(i + 1, 12):
                if rng.random() < 0.6:
                    edges.append((f"v{base + i}", f"v{base + j}", 1.0))
    edges.append(("v0", "v12", 1.0))
    return Graph.from_edges(edges, undirected=True)


def _sep(m, g):
    wv = np.asarray(m.state["vertex"])
    wv = wv / (np.linalg.norm(wv, axis=1, keepdims=True) + 1e-9)
    intra, cross = [], []
    for a in range(0, 24, 3):
        for b in range(1, 24, 3):
            s = wv[g.name2id[f"v{a}"]] @ wv[g.name2id[f"v{b}"]]
            (intra if (a < 12) == (b < 12) else cross).append(s)
    return np.mean(intra) - np.mean(cross)


def test_line_dp_trains(comm_graph):
    mesh = make_mesh(min(8, len(jax.devices())))
    m = LINE(comm_graph, seed=0)
    m.init(dim=16, order=2)
    m.train(sample_times=0.05, negative_samples=5, alpha=0.02, batch=64,
            steps_per_call=8, collision="mean", mesh=mesh, verbose=False)
    wv = np.asarray(m.state["vertex"])
    assert np.isfinite(wv).all()
    # replicated tables must agree across devices (single logical array)
    assert m.state["vertex"].shape == (24, 16)


def test_deepwalk_dp_learns_communities(comm_graph):
    mesh = make_mesh(min(8, len(jax.devices())))
    m = DeepWalk(comm_graph, seed=0)
    m.init(dim=16)
    m.train(walk_times=100, walk_steps=10, window_size=3,
            negative_samples=5, alpha=0.01, batch_walks=8,
            steps_per_call=8, collision="sum", mesh=mesh, verbose=False)
    assert _sep(m, comm_graph) > 0.2


def test_dp_streams_are_independent(comm_graph):
    """Each device must draw a DIFFERENT sample stream: with 8 devices
    the per-step sample count is 8x, so at equal wall steps the DP run
    must make more progress than a 1-device run (proxy: embeddings
    differ from the single-device result)."""
    mesh = make_mesh(min(8, len(jax.devices())))
    runs = []
    for m_ in (None, mesh):
        m = LINE(comm_graph, seed=0)
        m.init(dim=16, order=2)
        m.train(sample_times=0.02, negative_samples=3, alpha=0.02,
                batch=64, steps_per_call=4, collision="mean", mesh=m_,
                verbose=False)
        runs.append(np.asarray(m.state["vertex"]))
    assert not np.allclose(runs[0], runs[1])


def test_line_row_sharded_tables(comm_graph):
    """Large-graph mode: tables row-sharded over the mesh; the same
    jitted step runs with GSPMD-inserted collectives."""
    from smore_tpu.parallel.mesh import row_sharded, shard_state

    mesh = make_mesh(min(8, len(jax.devices())))
    m = LINE(comm_graph, seed=0)
    m.init(dim=16, order=2)
    m.state = shard_state(m.state, mesh)
    assert m.state["vertex"].sharding == row_sharded(mesh)
    m.train(sample_times=0.01, negative_samples=3, alpha=0.02, batch=64,
            steps_per_call=4, collision="mean", verbose=False)
    wv = np.asarray(m.state["vertex"])
    assert np.isfinite(wv).all() and wv.shape == (24, 16)


def test_rows_mode_is_first_class_and_single_chip_identical(comm_graph):
    """TrainDriver(sharding="rows") is the production large-table mode:
    one logical sample stream, tables row-sharded, GSPMD collectives.
    Its results must be IDENTICAL to the unsharded single-stream run
    (same logical program), and the output must stay row-sharded."""
    from smore_tpu.parallel.mesh import row_sharded

    kw = dict(sample_times=0.02, negative_samples=3, alpha=0.02, batch=64,
              steps_per_call=4, collision="mean", verbose=False)
    ref = LINE(comm_graph, seed=0)
    ref.init(dim=16, order=2)
    ref.train(**kw)

    mesh = make_mesh(min(8, len(jax.devices())))
    m = LINE(comm_graph, seed=0)
    m.init(dim=16, order=2)
    m.train(mesh=mesh, sharding="rows", **kw)
    assert m.state["vertex"].sharding == row_sharded(mesh)
    np.testing.assert_allclose(
        np.asarray(m.state["vertex"]), np.asarray(ref.state["vertex"]),
        rtol=2e-5, atol=2e-6,
    )


def test_rows_and_dp_reach_same_quality(comm_graph):
    """VERDICT r1 #2: DP and row-shard modes both learn the community
    structure on the bench-style graph (same budget in SAMPLES)."""
    mesh = make_mesh(min(8, len(jax.devices())))
    seps = {}
    for mode in ("dp", "rows"):
        m = DeepWalk(comm_graph, seed=0)
        m.init(dim=16)
        m.train(walk_times=100, walk_steps=10, window_size=3,
                negative_samples=5, alpha=0.01, batch_walks=8,
                steps_per_call=8, collision="sum", mesh=mesh,
                sharding=mode, verbose=False)
        seps[mode] = _sep(m, comm_graph)
    assert seps["dp"] > 0.2 and seps["rows"] > 0.2, seps


def test_banded_hogwild_on_mesh():
    """The banded step runs on a mesh via the driver's hogwild mode --
    per-device independent full-law streams on replicated tables,
    delta-psum merge once per jit call (the mesh analog of the
    reference's hogwild threads, LINE.cpp:162). Checks it trains, learns
    structure, and that the merge actually incorporated multi-device
    work."""
    rng = np.random.default_rng(5)
    nv, n_comm = 512, 4
    comm = rng.integers(0, n_comm, nv)
    edges = []
    for _ in range(6000):
        if rng.random() < 0.9:
            c = rng.integers(0, n_comm)
            members = np.flatnonzero(comm == c)
            a, b = members[rng.integers(0, len(members), 2)]
        else:
            a, b = rng.integers(0, nv, 2)
        if a != b:
            edges.append((f"v{a}", f"v{b}", 1.0))
    g = Graph.from_edges(edges, undirected=True)

    mesh = make_mesh(min(8, len(jax.devices())))
    kw = dict(sample_times=1.0, negative_samples=5, alpha=0.0125,
              batch=128, steps_per_call=8, shared_negatives=16,
              banded=True, band_size=128,
              hoist=2, verbose=False)
    m = LINE(g, seed=0)
    m.init(dim=64, order=2)
    m.train(mesh=mesh, **kw)
    assert m.last_driver.n_shards == min(8, len(jax.devices()))
    wv = np.asarray(m.state["vertex"])
    assert np.isfinite(wv).all()

    def sep(w):
        x = w / (np.linalg.norm(w, axis=1, keepdims=True) + 1e-9)
        vid = np.array([g.name2id[f"v{i}"] for i in range(nv)])
        r2 = np.random.default_rng(9)
        a = r2.integers(0, nv, 4000)
        b = r2.integers(0, nv, 4000)
        s = (x[vid[a]] * x[vid[b]]).sum(1)
        same = comm[a] == comm[b]
        return s[same].mean() - s[~same].mean()

    # structure: same-community cosine > cross-community cosine
    assert sep(wv) > 0.3

    # single-chip at the same TOTAL budget: different stream (merged
    # multi-device work) but matched quality
    m1 = LINE(g, seed=0)
    m1.init(dim=64, order=2)
    m1.train(**kw)
    assert not np.allclose(np.asarray(m1.state["vertex"]), wv)
    assert abs(sep(np.asarray(m1.state["vertex"])) - sep(wv)) < 0.15


def test_rows_mode_pads_uneven_tables(tmp_path):
    """Row sharding must divide evenly: a table whose row count is not a
    multiple of the device count is padded, trained sharded, and saved
    with exactly its vertices."""
    n_dev = min(8, len(jax.devices()))
    rng = np.random.default_rng(11)
    nv = 8 * 13 + 3  # never a multiple of the device count (>1)
    edges = [(f"v{a}", f"v{b}", 1.0)
             for a, b in rng.integers(0, nv, (1500, 2)) if a != b]
    g = Graph.from_edges(edges, undirected=True)
    assert g.n_vertices % n_dev
    m = LINE(g, seed=0)
    m.init(dim=8, order=2)
    m.train(sample_times=0.01, batch=64, steps_per_call=4,
            mesh=make_mesh(n_dev), sharding="rows", verbose=False)
    wv = m.state["vertex"]
    assert wv.shape[0] == -(-g.n_vertices // n_dev) * n_dev
    assert not wv.sharding.is_fully_replicated
    assert np.isfinite(np.asarray(wv)).all()
    out = tmp_path / "emb.txt"
    m.save_weights(str(out))
    lines = out.read_text().splitlines()
    assert lines[0] == f"{g.n_vertices} 8" and len(lines) == g.n_vertices + 1
