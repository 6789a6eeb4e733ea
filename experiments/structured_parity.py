"""Structure-shaped head-to-heads for the models whose round-2 parity
rows were chance-vs-chance (VERDICT r2 Weak #5): each model gets a
dataset shaped for what it actually learns, and a probe that can see it.
Both sides (ours on the GPU, compiled C++ reference) read the SAME files and
are scored by the SAME function.

  app      asymmetric proximity: probe = dot(vertex[u], context[v]) on
           true edges vs random pairs (APP.cpp:59-125; the stock CLI
           saves only w_vertex, so experiments/ref_app_main.cpp dumps
           both tables)
  textgcn  doc-word graph with planted topics + a field-1 stopword pool
           (UpdateCBOW negatives draw field 1, proNet.cpp:2952-2957);
           probe = same-topic AUC over doc rows (doc = neighbor sum,
           TEXTGCN.cpp:28-45)
  gcn      entity-tag graph with planted topics (entities field 0, tags
           field 1 -- the rows UpdateCBOW actually trains); probe =
           same-topic AUC over tag rows
  fine     user-item bipartite with genre communities (2 fields); probe
           = same-genre AUC over item rows (concat field-0|field-1
           projections, FINE.cpp SaveWeights)

Run: python experiments/structured_parity.py [app textgcn gcn fine]
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, "/root/repo")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from longtail_parity import (  # noqa: E402
    REF_DIR,
    ensure_binary,
    ensure_build_tree,
    ensure_fine_binary,
)

DIM = 64
SEED = 9
NPROC = os.cpu_count() or 1


def auc(pos, neg):
    pos, neg = np.asarray(pos, np.float64), np.asarray(neg, np.float64)
    return float((pos[:, None] > neg[None, :]).mean()
                 + 0.5 * (pos[:, None] == neg[None, :]).mean())


def load_emb(path):
    names, rows = [], []
    with open(path) as f:
        f.readline()
        for line in f:
            p = line.rstrip().split(" ")
            if len(p) < 2:
                continue
            names.append(p[0])
            rows.append(np.asarray(p[1:], dtype=np.float64))
    return dict(zip(names, range(len(names)))), np.stack(rows)


def topic_auc(emb_file, prefix, labels_of, n_pairs=4000, seed=0):
    """Same-topic vs different-topic cosine AUC over rows whose name
    starts with ``prefix``."""
    name2row, emb = load_emb(emb_file)
    emb = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-12)
    names = [nm for nm in name2row if nm.startswith(prefix)]
    rows = np.array([name2row[nm] for nm in names])
    labs = np.array([labels_of(nm) for nm in names])
    rng = np.random.default_rng(seed)
    a = rng.integers(0, len(rows), n_pairs * 6)
    b = rng.integers(0, len(rows), n_pairs * 6)
    keep = a != b
    a, b = a[keep], b[keep]
    s = (emb[rows[a]] * emb[rows[b]]).sum(1)
    same = labs[a] == labs[b]
    return auc(s[same][:n_pairs], s[~same][:n_pairs][:2000])


# ===================================================================== #
# APP
# ===================================================================== #
APP_TRAIN = "/tmp/sp_app_net.txt"


def make_app_dataset(n=20000, e=400000, n_comm=50):
    if os.path.exists(APP_TRAIN):
        return
    from bench import make_graph
    make_graph(APP_TRAIN, n=n, e=e, n_comm=n_comm, seed=SEED)


def ensure_app_binary():
    ensure_build_tree()
    path = os.path.join(REF_DIR, "cli", "ref_app")
    if not os.path.exists(path):
        here = os.path.dirname(os.path.abspath(__file__))
        subprocess.run(
            ["g++", "-std=c++11", "-fopenmp", "-Ofast",
             os.path.join(here, "ref_app_main.cpp"), "-o", path,
             f"-I{REF_DIR}/src", f"-I{REF_DIR}/src/model",
             f"-L{REF_DIR}/bin", "-lproNet", "-lm"],
            check=True)
    return path


def app_probe(vert_file, ctx_file, n_pairs=20000, seed=3):
    """Directional: dot(vertex[u], context[v]) on true edges vs random
    ordered pairs."""
    n2v, ve = load_emb(vert_file)
    n2c, ce = load_emb(ctx_file)
    rng = np.random.default_rng(seed)
    with open(APP_TRAIN) as f:
        lines = f.readlines()
    pos = []
    for i in rng.choice(len(lines), n_pairs, replace=False):
        a, b, _ = lines[i].split()
        pos.append(ve[n2v[a]] @ ce[n2c[b]])
    names = list(n2v.keys())
    ra = rng.choice(names, 1000)
    rb = rng.choice(names, 1000)
    neg = [ve[n2v[a]] @ ce[n2c[b]] for a, b in zip(ra, rb)]
    return auc(pos, neg)


def run_app():
    make_app_dataset()
    # the reference CLI's OWN defaults (cli/app.cpp: walk_times=100,
    # sample_times=20 -> 40M endpoint pairs): below ~10M pairs BOTH
    # implementations sit under the SGNS bootstrap transition on this
    # graph (measured round 5: the reference's tables stay at init
    # scale and read chance) -- a comparison there is meaningless
    wt, st, jump, negs = 100, 20, 0.15, 5

    # ours
    from smore_tpu.graph.graph import Graph
    from smore_tpu.io.embeddings import save_embeddings
    from smore_tpu.models.app import APP

    g = Graph.load_edge_list(APP_TRAIN, undirected=True)
    m = APP(g, seed=0)
    m.init(dim=DIM)
    t0 = time.time()
    m.train(walk_times=wt, sample_times=st, jump=jump,
            negative_samples=negs, verbose=False)
    print(f"app ours: {time.time()-t0:.0f}s", flush=True)
    save_embeddings("/tmp/sp_app_ours_v.txt", g.names,
                    np.asarray(m.state["vertex"]))
    save_embeddings("/tmp/sp_app_ours_c.txt", g.names,
                    np.asarray(m.state["context"]))
    ours = app_probe("/tmp/sp_app_ours_v.txt", "/tmp/sp_app_ours_c.txt")

    # reference
    t0 = time.time()
    subprocess.run(
        [ensure_app_binary(), APP_TRAIN, "/tmp/sp_app_ref_v.txt",
         "/tmp/sp_app_ref_c.txt", "1", str(wt), str(st), str(jump),
         str(negs), "0.025", str(NPROC)],
        check=True, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    print(f"app ref: {time.time()-t0:.0f}s", flush=True)
    ref = app_probe("/tmp/sp_app_ref_v.txt", "/tmp/sp_app_ref_c.txt")
    return "app", "edge-AUC (vertex x context)", ours, ref


# ===================================================================== #
# TEXTGCN
# ===================================================================== #
TG_TRAIN = "/tmp/sp_tg_net.txt"
TG_FIELD = "/tmp/sp_tg_field.txt"
TG_TOPICS = 20


def make_textgcn_dataset(topics=TG_TOPICS, words_pt=150, docs_pt=150,
                         stop=500, links=12, stop_links=3):
    if os.path.exists(TG_TRAIN):
        return
    rng = np.random.default_rng(SEED)
    lines, field = [], []
    for t in range(topics):
        for d in range(docs_pt):
            dn = f"d{t * docs_pt + d}"
            field.append(f"{dn} doc\n")
            for _ in range(links):
                wt_ = t if rng.random() < 0.85 else rng.integers(0, topics)
                w = rng.integers(0, words_pt)
                lines.append(f"{dn} w{wt_ * words_pt + w} 1\n")
            for _ in range(stop_links):
                lines.append(f"{dn} s{rng.integers(0, stop)} 1\n")
    for s in range(stop):
        field.append(f"s{s} stopword\n")
    for w in range(topics * words_pt):
        field.append(f"w{w} word\n")
    with open(TG_TRAIN, "w") as f:
        f.writelines(lines)
    with open(TG_FIELD, "w") as f:
        f.writelines(field)


def run_textgcn():
    make_textgcn_dataset()
    st = 10

    def labels_of(nm):
        return int(nm[1:]) // 150

    # ours
    from smore_tpu.graph.graph import Graph
    from smore_tpu.models.gcn import TEXTGCN

    g = Graph.load_edge_list(TG_TRAIN, undirected=True)
    m = TEXTGCN(g, seed=0)
    m.graph.load_field_meta(TG_FIELD)
    m.init(dim=DIM)
    t0 = time.time()
    m.train(sample_times=st, walk_steps=2, verbose=False)
    print(f"textgcn ours: {time.time()-t0:.0f}s", flush=True)
    m.save_weights("/tmp/sp_tg_ours.txt")
    ours = topic_auc("/tmp/sp_tg_ours.txt", "d", labels_of)

    # reference
    t0 = time.time()
    subprocess.run(
        [ensure_binary("textgcn"), "-train", TG_TRAIN, "-save",
         "/tmp/sp_tg_ref.txt", "-field", TG_FIELD, "-dimensions",
         str(DIM), "-sample_times", str(st), "-walk_steps", "2",
         "-alpha", "0.025", "-threads", str(NPROC)],
        check=True, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    print(f"textgcn ref: {time.time()-t0:.0f}s", flush=True)
    ref = topic_auc("/tmp/sp_tg_ref.txt", "d", labels_of)
    return "textgcn", "doc same-topic AUC", ours, ref


# ===================================================================== #
# GCN
# ===================================================================== #
GCN_TRAIN = "/tmp/sp_gcn_net.txt"
GCN_FIELD = "/tmp/sp_gcn_field.txt"


def make_gcn_dataset(topics=20, ents_pt=200, tags_pt=75, links=10):
    if os.path.exists(GCN_TRAIN):
        return
    rng = np.random.default_rng(SEED + 1)
    lines, field = [], []
    for t in range(topics):
        for e in range(ents_pt):
            en = f"e{t * ents_pt + e}"
            field.append(f"{en} entity\n")
            for _ in range(links):
                tt = t if rng.random() < 0.85 else rng.integers(0, topics)
                g = rng.integers(0, tags_pt)
                lines.append(f"{en} t{tt * tags_pt + g} 1\n")
    for t in range(topics * tags_pt):
        field.append(f"t{t} tag\n")
    with open(GCN_TRAIN, "w") as f:
        f.writelines(lines)
    with open(GCN_FIELD, "w") as f:
        f.writelines(field)


def run_gcn():
    make_gcn_dataset()
    st = 10

    def labels_of(nm):
        return int(nm[1:]) // 75

    from smore_tpu.graph.graph import Graph
    from smore_tpu.models.gcn import GCN

    g = Graph.load_edge_list(GCN_TRAIN, undirected=True)
    m = GCN(g, seed=0)
    m.graph.load_field_meta(GCN_FIELD)
    m.init(dim=DIM)
    t0 = time.time()
    m.train(sample_times=st, walk_steps=5, verbose=False)
    print(f"gcn ours: {time.time()-t0:.0f}s", flush=True)
    m.save_weights("/tmp/sp_gcn_ours.txt")
    ours = topic_auc("/tmp/sp_gcn_ours.txt", "t", labels_of)

    t0 = time.time()
    subprocess.run(
        [ensure_binary("gcn"), "-train", GCN_TRAIN, "-save",
         "/tmp/sp_gcn_ref.txt", "-field", GCN_FIELD, "-dimensions",
         str(DIM), "-sample_times", str(st), "-walk_steps", "5",
         "-alpha", "0.025", "-threads", str(NPROC)],
        check=True, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    print(f"gcn ref: {time.time()-t0:.0f}s", flush=True)
    ref = topic_auc("/tmp/sp_gcn_ref.txt", "t", labels_of)
    return "gcn", "tag same-topic AUC", ours, ref


# ===================================================================== #
# FINE
# ===================================================================== #
FINE_TRAIN = "/tmp/sp_fine_net.txt"
FINE_FIELD = "/tmp/sp_fine_field.txt"


def make_fine_dataset(genres=20, users_pg=150, items_pg=100, links=12):
    if os.path.exists(FINE_TRAIN):
        return
    rng = np.random.default_rng(SEED + 2)
    lines, field = [], []
    for gidx in range(genres):
        for u in range(users_pg):
            un = f"u{gidx * users_pg + u}"
            field.append(f"{un} user\n")
            for _ in range(links):
                gg = gidx if rng.random() < 0.85 else rng.integers(0, genres)
                i = rng.integers(0, items_pg)
                lines.append(f"{un} i{gg * items_pg + i} 1\n")
    for i in range(genres * items_pg):
        field.append(f"i{i} item\n")
    with open(FINE_TRAIN, "w") as f:
        f.writelines(lines)
    with open(FINE_FIELD, "w") as f:
        f.writelines(field)


def run_fine():
    make_fine_dataset()
    st = 10

    def labels_of(nm):
        return int(nm[1:]) // 100

    from smore_tpu.graph.graph import Graph
    from smore_tpu.models.fine import FINE

    g = Graph.load_edge_list(FINE_TRAIN, undirected=True)
    m = FINE(g, seed=0)
    m.graph.load_field_meta(FINE_FIELD)
    m.init(dim=DIM)
    t0 = time.time()
    m.train(sample_times=st, walk_steps=2, verbose=False)
    print(f"fine ours: {time.time()-t0:.0f}s", flush=True)
    m.save_weights("/tmp/sp_fine_ours.txt")
    ours = topic_auc("/tmp/sp_fine_ours.txt", "i", labels_of)

    t0 = time.time()
    subprocess.run(
        [ensure_fine_binary(), "fine", FINE_TRAIN, FINE_FIELD,
         "/tmp/sp_fine_ref.txt", str(st), "2", "5", "0.025", str(NPROC)],
        check=True, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    print(f"fine ref: {time.time()-t0:.0f}s", flush=True)
    ref = topic_auc("/tmp/sp_fine_ref.txt", "i", labels_of)
    return "fine", "item same-genre AUC", ours, ref


def main():
    want = sys.argv[1:] or ["app", "textgcn", "gcn", "fine"]
    rows = []
    for w in want:
        rows.append({"app": run_app, "textgcn": run_textgcn,
                     "gcn": run_gcn, "fine": run_fine}[w]())
        name, metric, ours, ref = rows[-1]
        print(f"{name:8s} ours={ours:.4f} ref={ref:.4f}  ({metric})",
              flush=True)
    print("\n| model | metric | ours | reference |")
    print("|---|---|---|---|")
    for name, metric, ours, ref in rows:
        print(f"| {name} | {metric} | {ours:.4f} | {ref:.4f} |")


if __name__ == "__main__":
    main()
