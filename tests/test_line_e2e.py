"""End-to-end LINE test on the README toy net: output-format parity and
embedding sanity (connected pairs score above unconnected ones)."""

import numpy as np

from smore_tpu.graph.graph import Graph
from smore_tpu.io.embeddings import load_embeddings
from smore_tpu.models.line import LINE


def train_line(toy_net_path, order, dim=8):
    g = Graph.load_edge_list(toy_net_path, undirected=True, use_native=False)
    m = LINE(g, seed=0)
    m.init(dim=dim, order=order)
    # NOTE: tiny batch + modest alpha -- on a 6-vertex graph a large batch
    # sums hundreds of colliding updates per row per step (the batched
    # analog of hogwild races, SURVEY.md 7.3) and diverges.
    m.train(
        sample_times=0.02,
        negative_samples=5,
        alpha=0.025,
        batch=64,
        steps_per_call=16,
        verbose=False,
    )
    return m


def test_line_o2_output_format(toy_net_path, tmp_path):
    m = train_line(toy_net_path, order=2)
    out = tmp_path / "rep.txt"
    m.save_weights(str(out))
    lines = out.read_text().strip().split("\n")
    assert lines[0] == "6 8"
    assert len(lines) == 7
    emb = load_embeddings(str(out))
    assert set(emb) == {"userA", "userB", "userC", "itemA", "itemB", "itemC"}
    assert all(len(v) == 8 for v in emb.values())
    assert all(np.isfinite(v).all() for v in emb.values())


def _mean_score(m, pairs):
    wv = np.asarray(m.state["vertex"])
    wc = np.asarray(m.state.get("context", m.state["vertex"]))
    n2i = m.graph.name2id
    return np.mean([wv[n2i[a]] @ wc[n2i[b]] for a, b in pairs])


def test_line_o2_learns_structure(toy_net_path):
    m = train_line(toy_net_path, order=2)
    connected = [("userA", "itemA"), ("userA", "itemC"), ("userB", "itemB"),
                 ("userC", "itemA")]
    not_connected = [("userA", "itemB"), ("userC", "itemB"), ("userC", "itemC")]
    assert _mean_score(m, connected) > _mean_score(m, not_connected)


def test_line_o1_learns_structure(toy_net_path):
    m = train_line(toy_net_path, order=1)
    assert "context" not in m.state  # shared table
    connected = [("userA", "itemA"), ("userA", "itemC"), ("userB", "itemB"),
                 ("userC", "itemA")]
    not_connected = [("userA", "itemB"), ("userC", "itemB")]
    assert _mean_score(m, connected) > _mean_score(m, not_connected)


def test_line_pretrain_roundtrip(toy_net_path, tmp_path):
    m = train_line(toy_net_path, order=2)
    out = tmp_path / "rep.txt"
    m.save_weights(str(out))

    g2 = Graph.load_edge_list(toy_net_path, undirected=True, use_native=False)
    m2 = LINE(g2, seed=1)
    m2.init(dim=8, order=2)
    m2.load_pretrain(str(out))
    w1 = np.asarray(m.state["vertex"])
    w2 = np.asarray(m2.state["vertex"])
    # 6-sig-digit text roundtrip
    np.testing.assert_allclose(w1, w2, rtol=1e-4, atol=1e-5)


def test_driver_times_first_call_apart(toy_net_path):
    """TrainDriver reports the executed samples, the wall time, the first
    (compiling) call's time and the steady rate of the calls after it."""
    m = LINE.load_edge_list(toy_net_path)
    m.init(dim=8, order=2)
    m.train(sample_times=0.002, batch=8, steps_per_call=50, group=1,
            hoist=1, verbose=False)
    d = m.last_driver
    per_call = d.steps_per_call * d.samples_per_step
    assert d.executed_samples >= 2000 and d.executed_samples % per_call == 0
    assert d.executed_samples > per_call  # several calls
    assert 0 < d.first_call_s < d.wall_s
    assert d.steady_samples_per_s > 0
