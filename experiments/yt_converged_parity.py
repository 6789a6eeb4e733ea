"""Youtube-scale quality parity at CONVERGED budgets (VERDICT r2 #1).

Head-to-head vs the compiled C++ reference on the faithful YT-scale
graph (bench.make_youtube_graph) at 40M, 120M AND 400M samples:
  - community-AUC (cosine), the structural gate used everywhere
  - micro-F1 on the planted 100-community labels via a softmax probe
    (the BASELINE.json-designated "LINE o1+o2 micro-F1" protocol:
    probe on the CONCAT of order-1 and order-2 embeddings, plus the
    o2-only column)

Reference arms (produced by /tmp/ref_yt_runs.sh on all host cores):
             /tmp/ref_yt_o2_120M.txt  /tmp/ref_yt_o2_400M.txt
             /tmp/ref_yt_o1_120M.txt  (/tmp/yt_ref_line.txt = o2 40M)

Ours: the production banded config at the same budgets (the fused GPU
kernel step where the card runs it).

Run on the GPU:
  python experiments/yt_converged_parity.py ours 40 120 400   # o2 arms
  python experiments/yt_converged_parity.py o1 120            # o1 arm
  python experiments/yt_converged_parity.py ref               # score refs
  python experiments/yt_converged_parity.py microf1           # probe
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, "/root/repo")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from bench import make_youtube_graph  # noqa: E402
from microf1_scale import softmax_probe  # noqa: E402
from yt_scale_bench import YT, community_auc, labels  # noqa: E402

REF_FILES = {
    ("o2", 40): "/tmp/yt_ref_line.txt",
    ("o2", 120): "/tmp/ref_yt_o2_120M.txt",
    ("o2", 400): "/tmp/ref_yt_o2_400M.txt",
    ("o1", 120): "/tmp/ref_yt_o1_120M.txt",
}
OUR_EMB = "/tmp/ours_yt_{order}_{budget}M.npz"


def train_ours(order, budget, **cfg):
    from smore_tpu.graph.graph import Graph
    from smore_tpu.models.line import LINE

    g = Graph.load_edge_list(YT, undirected=True)
    m = LINE(g, seed=0)
    m.init(dim=64, order=order)
    t0 = time.time()
    m.train(sample_times=budget, verbose=False, **cfg)
    float(m.state["vertex"][0, 0])
    dt = time.time() - t0
    emb = np.asarray(m.state["vertex"])
    auc = community_auc(emb, m.graph.names)
    tag = f"o{order}"
    print(f"ours {tag} @{budget}M: AUC={auc:.4f} "
          f"({budget / dt:.1f} M samples/s, {dt:.0f}s) cfg={cfg}",
          flush=True)
    np.savez_compressed(
        OUR_EMB.format(order=tag, budget=budget),
        emb=emb, names=np.asarray(m.graph.names),
    )
    return auc


def load_ref(path):
    names, rows = [], []
    with open(path) as f:
        f.readline()
        for line in f:
            p = line.split()
            names.append(p[0])
            rows.append(np.asarray(p[1:], dtype=np.float32))
    return names, np.stack(rows)


def score_refs():
    for (order, budget), path in REF_FILES.items():
        if not os.path.exists(path):
            print(f"ref {order} @{budget}M: MISSING {path}", flush=True)
            continue
        names, emb = load_ref(path)
        auc = community_auc(emb, names)
        print(f"ref  {order} @{budget}M: AUC={auc:.4f}", flush=True)


def _by_name_matrix(emb, names, n):
    out = np.zeros((n, emb.shape[1]), dtype=np.float32)
    for row, nm in enumerate(names):
        out[int(nm[1:])] = emb[row]
    return out


def microf1(probe_n=200_000):
    """Softmax probe on o2-only and on concat(o1, o2), both sides at
    120M (the converged budget with reference arms for both orders).
    The probe trains on a seeded ``probe_n``-vertex subsample (identical
    for both sides) -- full-batch GD over 1.1M x 128 on this 2-core host
    would dominate wall-clock without changing the comparison."""
    n = 1_100_000
    lab = labels()
    sub = np.random.default_rng(123).choice(n, probe_n, replace=False)
    results = {}
    for side in ("ours", "ref"):
        mats = {}
        for order, budget in (("o1", 120), ("o2", 120)):
            if side == "ours":
                f = OUR_EMB.format(order=order, budget=budget)
                if not os.path.exists(f):
                    print(f"microf1: missing {f}", flush=True)
                    return
                z = np.load(f)
                mats[order] = _by_name_matrix(z["emb"], list(z["names"]), n)
            else:
                names, emb = load_ref(REF_FILES[(order, budget)])
                mats[order] = _by_name_matrix(emb, names, n)
        for probe_on, mat in (
            ("o2", mats["o2"]),
            ("o1+o2", np.concatenate([mats["o1"], mats["o2"]], axis=1)),
        ):
            f1 = softmax_probe(mat[sub], lab[sub], iters=150)
            results[(side, probe_on)] = f1
            print(f"micro-F1 {side:4s} {probe_on}: {f1:.4f}", flush=True)
    return results


def main():
    make_youtube_graph(YT)
    args = sys.argv[1:] or ["ref", "ours", "40", "120", "400", "microf1"]
    budgets = [int(a) for a in args if a.isdigit()] or [120]
    if "ref" in args:
        score_refs()
    if "ours" in args:
        for b in budgets:
            train_ours(2, b)
    if "o1" in args:
        for b in budgets:
            train_ours(1, b)
    if "microf1" in args:
        microf1()


if __name__ == "__main__":
    main()
