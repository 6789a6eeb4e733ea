"""Checkpoint/resume through TrainDriver and the CLI.

The reference's only persistence is the final text dump + warm start
(SURVEY.md 5.4); mid-train checkpoint/resume is a production upgrade.
The contract tested here: kill-at-50%-then-resume is STEP-IDENTICAL to
an uninterrupted run (the alpha schedule is a pure function of the
restored step counter and the PRNG key is checkpointed with the state).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from smore_tpu.graph.graph import Graph
from smore_tpu.models.line import LINE


def _toy_graph(tmp_path, n=60, seed=0):
    rng = np.random.default_rng(seed)
    path = tmp_path / "net.txt"
    with open(path, "w") as f:
        for _ in range(400):
            a, b = rng.integers(0, n, 2)
            if a != b:
                f.write(f"n{a} n{b} {rng.uniform(0.5, 2.0):.3f}\n")
    return str(path)


def _make_model(path):
    g = Graph.load_edge_list(path, undirected=True)
    m = LINE(g)
    m.init(dim=8, order=2)
    return m


TRAIN_KW = dict(
    sample_times=0.004,  # 4000 samples
    negative_samples=2,
    alpha=0.02,
    batch=64,
    steps_per_call=4,  # ~16 calls total
    group=1,
    verbose=False,
)


def test_kill_at_50pct_then_resume_is_step_identical(tmp_path):
    net = _toy_graph(tmp_path)

    # Uninterrupted run (no checkpointing).
    m_ref = _make_model(net)
    m_ref.train(**TRAIN_KW)
    ref_v = np.asarray(m_ref.state["vertex"])
    ref_c = np.asarray(m_ref.state["context"])

    # Interrupted run: checkpoint every call, die after the ~8th call.
    ckpt = str(tmp_path / "ckpt")
    m_a = _make_model(net)
    m_a.set_checkpoint(ckpt, every=1)

    from smore_tpu.models.base import TrainDriver

    orig_save = TrainDriver._save_ckpt
    calls = {"n": 0}

    def killing_save(self, state, key, done):
        orig_save(self, state, key, done)
        calls["n"] += 1
        if calls["n"] == 8:
            raise KeyboardInterrupt("simulated preemption")

    TrainDriver._save_ckpt = killing_save
    try:
        with pytest.raises(KeyboardInterrupt):
            m_a.train(**TRAIN_KW)
    finally:
        TrainDriver._save_ckpt = orig_save
    assert calls["n"] == 8

    # Fresh process analog: new model object, resume from the checkpoint.
    m_b = _make_model(net)
    m_b.set_checkpoint(ckpt, every=1)
    m_b.train(**TRAIN_KW)

    np.testing.assert_array_equal(np.asarray(m_b.state["vertex"]), ref_v)
    np.testing.assert_array_equal(np.asarray(m_b.state["context"]), ref_c)


def test_resume_skips_completed_run(tmp_path):
    net = _toy_graph(tmp_path)
    ckpt = str(tmp_path / "ckpt2")
    m = _make_model(net)
    m.set_checkpoint(ckpt, every=1)
    m.train(**TRAIN_KW)
    done_v = np.asarray(m.state["vertex"])

    # Resuming a finished run must be a no-op on the tables.
    m2 = _make_model(net)
    m2.set_checkpoint(ckpt, every=1)
    m2.train(**TRAIN_KW)
    np.testing.assert_array_equal(np.asarray(m2.state["vertex"]), done_v)


def _seq_graph(seed=4, n_items=10, n_users=24):
    rng = np.random.default_rng(seed)
    edges = []
    for u in range(n_users):
        start = rng.integers(0, n_items)
        for t in range(int(rng.integers(5, 9))):
            edges.append((f"u{u}", f"i{(start + t) % n_items}", 1.0))
    return Graph.from_edges(edges, undirected=False)


def test_sasrec_interrupt_then_resume_is_epoch_identical(tmp_path):
    """The flax/optax family checkpoints too: params + adam state + PRNG
    chain. Dying after epoch 2 of 4 and resuming in a fresh model must
    reproduce the uninterrupted trajectory exactly."""
    from smore_tpu.models.sasrec import SASRec

    g = _seq_graph()
    kw = dict(epochs=4, batch_size=16, alpha=0.005, verbose=False)

    m_ref = SASRec(g, seed=0)
    m_ref.init(dim=8, max_seq_len=8, num_blocks=1)
    m_ref.train(**kw)
    ref_leaves = jax.device_get(jax.tree.leaves(m_ref.params))

    # "Die" after epoch 2: same config, fewer epochs, checkpointing on.
    ckpt = str(tmp_path / "sas_ckpt")
    m_a = SASRec(g, seed=0)
    m_a.init(dim=8, max_seq_len=8, num_blocks=1)
    m_a.train(**{**kw, "epochs": 2}, checkpoint=ckpt)

    # Fresh-process analog: new model resumes epochs 3-4.
    m_b = SASRec(g, seed=0)
    m_b.init(dim=8, max_seq_len=8, num_blocks=1)
    m_b.train(**kw, checkpoint=ckpt)

    for got, want in zip(jax.tree.leaves(m_b.params), ref_leaves):
        np.testing.assert_array_equal(np.asarray(got), want)

    # Resuming a finished run is a no-op.
    m_c = SASRec(g, seed=0)
    m_c.init(dim=8, max_seq_len=8, num_blocks=1)
    m_c.train(**kw, checkpoint=ckpt)
    for got, want in zip(jax.tree.leaves(m_c.params), ref_leaves):
        np.testing.assert_array_equal(np.asarray(got), want)


def test_transe_interrupt_then_resume_is_epoch_identical(tmp_path):
    """KG family: tables + PRNG chain checkpoint at epoch granularity;
    the lr schedule resumes from the restored epoch counter."""
    from smore_tpu.models.kg import TransE

    rng = np.random.default_rng(3)
    lines = [f"e{rng.integers(0, 30)} r{rng.integers(0, 3)} "
             f"e{rng.integers(0, 30)}\n" for _ in range(200)]
    tri = tmp_path / "triples.txt"
    tri.write_text("".join(lines))

    kw = dict(epochs=6, batch=32, alpha=0.05, verbose=False)
    m_ref = TransE.load_triples(str(tri))
    m_ref.init(dim=8)
    m_ref.train(**kw)
    ref_e = np.asarray(m_ref.state["entity"])

    # Interrupted run: the lr schedule depends on the TOTAL epoch count,
    # so simulate preemption by dying inside the full-length run (after
    # the 3rd epoch save) rather than by training fewer epochs.
    import smore_tpu.utils.checkpoint as ckpt_mod

    ckpt = str(tmp_path / "kg_ckpt")
    orig_save = ckpt_mod.save_checkpoint
    calls = {"n": 0}

    def killing_save(*a, **k):
        orig_save(*a, **k)
        calls["n"] += 1
        if calls["n"] == 3:
            raise KeyboardInterrupt("simulated preemption")

    ckpt_mod.save_checkpoint = killing_save
    try:
        m_a = TransE.load_triples(str(tri))
        m_a.init(dim=8)
        with pytest.raises(KeyboardInterrupt):
            m_a.train(**kw, checkpoint=ckpt)
    finally:
        ckpt_mod.save_checkpoint = orig_save
    assert calls["n"] == 3

    m_b = TransE.load_triples(str(tri))
    m_b.init(dim=8)
    m_b.train(**kw, checkpoint=ckpt)
    np.testing.assert_array_equal(np.asarray(m_b.state["entity"]), ref_e)


def test_sne_checkpoint_passthrough(tmp_path):
    """SNE/CPR/TPR forward checkpoint kwargs to TrainDriver; resuming a
    finished run is a no-op (the driver contract is pinned above)."""
    from smore_tpu.models.sne import SNE

    rng = np.random.default_rng(5)
    net = tmp_path / "signed.txt"
    with open(net, "w") as f:
        for _ in range(200):
            a, b = rng.integers(0, 40, 2)
            if a != b:
                f.write(f"s{a} s{b} {rng.choice([-1.0, 1.0])}\n")

    ckpt = str(tmp_path / "sne_ckpt")
    kw = dict(epochs=2, samples_per_edge=1, alpha=0.02, batch=64,
              steps_per_call=2, verbose=False)
    m = SNE.load_edge_list(str(net), undirected=True)
    m.init(dim=8)
    m.train(**kw, checkpoint=ckpt)
    from smore_tpu.utils.checkpoint import checkpoint_exists

    assert checkpoint_exists(ckpt)
    done = np.asarray(m.state["source"])

    m2 = SNE.load_edge_list(str(net), undirected=True)
    m2.init(dim=8)
    m2.train(**kw, checkpoint=ckpt)
    np.testing.assert_array_equal(np.asarray(m2.state["source"]), done)


def test_jodie_resume_is_epoch_identical(tmp_path):
    """JODIE: statics + RNN params + final dynamic tables + PRNG chain.
    Interrupt after 2 of 4 epochs (constant lr, so a shorter run IS the
    prefix of the longer one) and resume in a fresh model."""
    from smore_tpu.models.jodie import JODIE

    rng = np.random.default_rng(6)
    path = tmp_path / "inter.txt"
    with open(path, "w") as f:
        for t in range(120):
            f.write(f"u{rng.integers(0, 8)} i{rng.integers(0, 12)} "
                    f"{t}.0\n")
    kw = dict(epochs=4, learning_rate=0.01, verbose=False)

    m_ref = JODIE.load_interactions(str(path))
    m_ref.init(dim=8)
    m_ref.train(**kw)
    ref_us = np.asarray(m_ref.state["user_static"])
    ref_ud = np.asarray(m_ref.user_dyn)

    ckpt = str(tmp_path / "jodie_ckpt")
    m_a = JODIE.load_interactions(str(path))
    m_a.init(dim=8)
    m_a.train(**{**kw, "epochs": 2}, checkpoint=ckpt)

    m_b = JODIE.load_interactions(str(path))
    m_b.init(dim=8)
    m_b.train(**kw, checkpoint=ckpt)
    np.testing.assert_array_equal(
        np.asarray(m_b.state["user_static"]), ref_us)
    np.testing.assert_array_equal(np.asarray(m_b.user_dyn), ref_ud)


def test_cli_checkpoint_flag(tmp_path):
    net = _toy_graph(tmp_path)
    out = str(tmp_path / "emb.txt")
    ckpt = str(tmp_path / "cli_ckpt")
    from smore_tpu.cli.main import main

    rc = main([
        "line", "-train", net, "-save", out, "-dimensions", "8",
        "-sample_times", "0.002", "-batch", "64",
        "-checkpoint", ckpt,
    ])
    assert rc == 0
    from smore_tpu.utils.checkpoint import checkpoint_exists

    assert checkpoint_exists(ckpt)
    header = open(out).readline().split()
    assert len(header) == 2 and header[1] == "8"


def test_hogwild_mesh_kill_resume_is_step_identical(tmp_path):
    """Checkpoint/resume under the hogwild mesh mode (banded step). The
    checkpoint carries the (n_dev, 2) per-device key ARRAY; resume must
    continue every device's stream where it left off -- kill-at-50%
    equals the uninterrupted mesh run exactly."""
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple (virtual) devices")
    from smore_tpu.parallel.mesh import make_mesh

    net = _toy_graph(tmp_path, n=256, seed=3)
    mesh = make_mesh(min(8, len(jax.devices())))
    kw = dict(sample_times=0.02, negative_samples=2, alpha=0.02,
              batch=128, steps_per_call=8, shared_negatives=16,
              banded=True, band_size=64,
              hoist=2, mesh=mesh, verbose=False)

    m_ref = _make_model(net)
    m_ref.init(dim=64, order=2)
    m_ref.train(**kw)
    ref_v = np.asarray(m_ref.state["vertex"])

    ckpt = str(tmp_path / "hog_ckpt")
    m_a = _make_model(net)
    m_a.init(dim=64, order=2)
    m_a.set_checkpoint(ckpt, every=1)

    from smore_tpu.models.base import TrainDriver

    orig_save = TrainDriver._save_ckpt
    calls = {"n": 0}

    def killing_save(self, state, key, done):
        orig_save(self, state, key, done)
        calls["n"] += 1
        if calls["n"] == 2:
            raise KeyboardInterrupt("simulated preemption")

    TrainDriver._save_ckpt = killing_save
    try:
        with pytest.raises(KeyboardInterrupt):
            m_a.train(**kw)
    finally:
        TrainDriver._save_ckpt = orig_save

    m_b = _make_model(net)
    m_b.init(dim=64, order=2)
    m_b.set_checkpoint(ckpt, every=1)
    m_b.train(**kw)
    np.testing.assert_array_equal(np.asarray(m_b.state["vertex"]), ref_v)
