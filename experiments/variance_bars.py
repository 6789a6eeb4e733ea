"""Variance bars for the designated metrics (VERDICT r3 item 7).

>= 3 seeds per side for:
  (a) the 40M-sample community-AUC gate (LINE o2, YT-scale graph)
  (b) the designated micro-F1 (softmax probe on o1+o2 concat, and
      o2-only) at the same 40M budget

Ours runs the production default config per seed on the GPU; the
reference arms run the compiled CLI with -threads all (its RNG is
time-seeded, so consecutive runs ARE independent seeds,
src/random.cpp:5-13).

Run on the GPU:  python experiments/variance_bars.py [n_seeds]
(the reference arms run on all host cores: six o1/o2 pairs + three
gate arms.)
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, "/root/repo")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from bench import make_youtube_graph  # noqa: E402
from longtail_parity import ensure_build_tree, REF_DIR  # noqa: E402
from microf1_scale import softmax_probe  # noqa: E402
from yt_scale_bench import YT, community_auc, labels  # noqa: E402

BUDGET = 40  # millions of samples


def run_ours(seed, order):
    from smore_tpu.graph.graph import Graph
    from smore_tpu.models.line import LINE

    g = Graph.load_edge_list(YT, undirected=True)
    m = LINE(g, seed=seed)
    m.init(dim=64, order=order)
    t0 = time.time()
    m.train(sample_times=BUDGET, verbose=False)
    emb = np.asarray(m.state["vertex"])
    dt = time.time() - t0
    return list(g.names), emb, dt


def run_ref(order):
    ensure_build_tree()
    out = f"/tmp/var_ref_o{order}.txt"
    subprocess.run(
        [os.path.join(REF_DIR, "cli", "line"), "-train", YT, "-save",
         out, "-order", str(order), "-dimensions", "64",
         "-sample_times", str(BUDGET), "-negative_samples", "5",
         "-threads", str(os.cpu_count() or 1)],
        check=True, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    from smore_tpu.io.embeddings import load_embeddings

    d = load_embeddings(out)
    names = list(d.keys())
    return names, np.stack([d[nm] for nm in names])


N_FULL = 1_100_000


def by_name(names, emb):
    out = np.zeros((N_FULL, emb.shape[1]), dtype=np.float32)
    for row, nm in enumerate(names):
        out[int(nm[1:])] = emb[row]
    return out


def stats(tag, vals):
    a = np.asarray(vals)
    sd = a.std(ddof=1) if len(a) > 1 else 0.0
    print(f"{tag}: {' '.join(f'{v:.4f}' for v in a)}  -> "
          f"{a.mean():.4f} +- {sd:.4f} (sample sd, ddof=1)", flush=True)
    return a.mean(), sd


def main():
    n_seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    make_youtube_graph(YT)
    lab = labels()

    sub = np.random.default_rng(123).choice(N_FULL, 200_000,
                                            replace=False)

    ours_auc, ours_f1c, ours_f1o2 = [], [], []
    for s in range(n_seeds):
        nm2, e2, dt = run_ours(s, 2)
        nm1, e1, _ = run_ours(s, 1)
        ours_auc.append(community_auc(e2, nm2))
        m2 = by_name(nm2, e2)
        m1 = by_name(nm1, e1)
        ours_f1o2.append(softmax_probe(m2[sub], lab[sub], iters=150))
        ours_f1c.append(softmax_probe(
            np.concatenate([m1, m2], 1)[sub], lab[sub], iters=150))
        print(f"ours seed {s}: gate-AUC {ours_auc[-1]:.4f} "
              f"f1(o1+o2) {ours_f1c[-1]:.4f} f1(o2) {ours_f1o2[-1]:.4f} "
              f"({BUDGET/dt:.1f} M/s)", flush=True)

    ref_auc, ref_f1c, ref_f1o2 = [], [], []
    for s in range(n_seeds):
        nm2, e2 = run_ref(2)
        nm1, e1 = run_ref(1)
        ref_auc.append(community_auc(e2, nm2))
        m2 = by_name(nm2, e2)
        m1 = by_name(nm1, e1)
        ref_f1o2.append(softmax_probe(m2[sub], lab[sub], iters=150))
        ref_f1c.append(softmax_probe(
            np.concatenate([m1, m2], 1)[sub], lab[sub], iters=150))
        print(f"ref seed {s}: gate-AUC {ref_auc[-1]:.4f} "
              f"f1(o1+o2) {ref_f1c[-1]:.4f} f1(o2) {ref_f1o2[-1]:.4f}",
              flush=True)

    print("\n=== mean +- sd over seeds ===")
    stats("ours gate-AUC ", ours_auc)
    stats("ref  gate-AUC ", ref_auc)
    stats("ours f1 o1+o2 ", ours_f1c)
    stats("ref  f1 o1+o2 ", ref_f1c)
    stats("ours f1 o2    ", ours_f1o2)
    stats("ref  f1 o2    ", ref_f1o2)


if __name__ == "__main__":
    main()
