"""BPR quality parity: ours (JAX) vs the C++ reference on a synthetic
implicit-feedback dataset shaped like MovieLens-1M (the real dataset is
unavailable offline; BASELINE.md row "BPR AUC + recall@10").

Dataset: 6k users x 3k items, 60 latent taste clusters; each user draws
~160 interactions from their cluster's item pool (plus 10% noise), split
80/20 train/test by user. Both sides train on the SAME edge list at a
matched sample budget, then are scored identically:
  - AUC: P(score(test item) > score(random unseen item)) per user
  - recall@10: fraction of test items in the user's top-10 unseen ranking
Run: python experiments/bpr_parity.py  (GPU + compiles the reference)
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, "/root/repo")

TRAIN = "/tmp/bpr_train.txt"
TEST = "/tmp/bpr_test.npz"
REF_DIR = "/tmp/smore_ref_build"
N_USERS, N_ITEMS, N_CLUST = 6000, 3000, 60
DIM = 64
SAMPLE_TIMES = 20  # millions of pair draws


def make_dataset(seed: int = 0) -> None:
    if os.path.exists(TRAIN) and os.path.exists(TEST):
        return
    rng = np.random.default_rng(seed)
    uc = rng.integers(0, N_CLUST, N_USERS)  # user cluster
    ic = rng.integers(0, N_CLUST, N_ITEMS)  # item cluster
    items_by_c = [np.where(ic == c)[0] for c in range(N_CLUST)]
    tr_u, tr_i, te_u, te_i = [], [], [], []
    for u in range(N_USERS):
        pool = items_by_c[uc[u]]
        k = rng.integers(120, 200)
        chosen = rng.choice(pool, size=min(k, len(pool)), replace=False)
        noise = rng.integers(0, N_ITEMS, max(1, k // 10))
        all_i = np.unique(np.concatenate([chosen, noise]))
        rng.shuffle(all_i)
        cut = int(0.8 * len(all_i))
        tr_u += [u] * cut
        tr_i += list(all_i[:cut])
        te_u += [u] * (len(all_i) - cut)
        te_i += list(all_i[cut:])
    with open(TRAIN, "w") as f:
        for u, i in zip(tr_u, tr_i):
            f.write(f"u{u} i{i} 1\n")
    np.savez(TEST, te_u=np.array(te_u), te_i=np.array(te_i),
             tr_u=np.array(tr_u), tr_i=np.array(tr_i))


def evaluate(user_emb: np.ndarray, item_emb: np.ndarray, seed=3):
    """user_emb (N_USERS, D), item_emb (N_ITEMS, D) in label order."""
    d = np.load(TEST)
    te_u, te_i, tr_u, tr_i = d["te_u"], d["te_i"], d["tr_u"], d["tr_i"]
    rng = np.random.default_rng(seed)

    # AUC over 50k (test positive, random negative) pairs
    sel = rng.integers(0, len(te_u), 50_000)
    neg = rng.integers(0, N_ITEMS, 50_000)
    s_pos = np.sum(user_emb[te_u[sel]] * item_emb[te_i[sel]], axis=1)
    s_neg = np.sum(user_emb[te_u[sel]] * item_emb[neg], axis=1)
    auc = float(np.mean(s_pos > s_neg) + 0.5 * np.mean(s_pos == s_neg))

    # recall@10 over 1000 sampled users
    from collections import defaultdict
    seen = defaultdict(set)
    for u, i in zip(tr_u, tr_i):
        seen[u].add(i)
    test_by_u = defaultdict(set)
    for u, i in zip(te_u, te_i):
        test_by_u[u].add(i)
    users = rng.choice(list(test_by_u.keys()), 1000, replace=False)
    hits = tot = 0
    scores_all = user_emb[users] @ item_emb.T  # (1000, N_ITEMS)
    for row, u in enumerate(users):
        s = scores_all[row].copy()
        s[list(seen[u])] = -np.inf
        top = np.argpartition(-s, 10)[:10]
        hits += len(set(top) & test_by_u[u])
        tot += min(10, len(test_by_u[u]))
    return auc, hits / tot


def load_ref_embeddings(path):
    ue = np.zeros((N_USERS, DIM), dtype=np.float32)
    ie = np.zeros((N_ITEMS, DIM), dtype=np.float32)
    with open(path) as f:
        f.readline()
        for line in f:
            p = line.split()
            if p[0][0] == "u":
                ue[int(p[0][1:])] = np.array(p[1:], dtype=np.float32)
            else:
                ie[int(p[0][1:])] = np.array(p[1:], dtype=np.float32)
    return ue, ie


def run_reference(model="bpr"):
    out = f"/tmp/{model}_ref_out.txt"
    subprocess.run(
        [os.path.join(REF_DIR, "cli", model),
         "-train", TRAIN, "-save", out, "-dimensions", str(DIM),
         "-sample_times", str(SAMPLE_TIMES), "-alpha", "0.025",
         "-threads", str(os.cpu_count() or 1)],
        check=True, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    return load_ref_embeddings(out)


def run_ours(model="bpr"):
    from smore_tpu.graph.graph import Graph
    from smore_tpu.models import rec
    from smore_tpu.models.hpe import HPE

    cls = {"bpr": rec.BPR, "mf": rec.MF, "warp": rec.WARP,
           "skewopt": rec.SkewOPT, "hpe": HPE}[model]
    # the reference's mf/bpr/warp/skewopt CLIs hardcode DIRECTED loading
    # (cli/{mf,bpr,warp}.cpp:57-63, cli/skewopt.cpp:69); matched arms
    # must too (round-4 root cause of the rec recall deficits)
    undirected = model == "hpe"
    g = Graph.load_edge_list(TRAIN, undirected=undirected)
    m = cls(g, seed=0)
    m.init(dim=DIM)
    m.train(sample_times=1, verbose=False)  # warm/compile
    t0 = time.time()
    m.train(sample_times=SAMPLE_TIMES, verbose=False)
    emb = np.asarray(m.state["vertex"])
    dt = time.time() - t0
    print(f"ours: {SAMPLE_TIMES/dt:.1f} M pair-draws/s wall", flush=True)
    ue = np.zeros((N_USERS, DIM), dtype=np.float32)
    ie = np.zeros((N_ITEMS, DIM), dtype=np.float32)
    for name, vid in g.name2id.items():
        if name[0] == "u":
            ue[int(name[1:])] = emb[vid]
        else:
            ie[int(name[1:])] = emb[vid]
    return ue, ie


def main():
    make_dataset()
    models = sys.argv[1:] or ["bpr"]
    for model in models:
        ue, ie = run_ours(model)
        auc, rec = evaluate(ue, ie)
        print(f"{model} ours      : AUC={auc:.4f}  recall@10={rec:.4f}",
              flush=True)
        ue_r, ie_r = run_reference(model)
        auc_r, rec_r = evaluate(ue_r, ie_r)
        print(f"{model} reference : AUC={auc_r:.4f}  recall@10={rec_r:.4f}",
              flush=True)


if __name__ == "__main__":
    main()
