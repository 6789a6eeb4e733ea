"""Youtube-scale LINE measurement: banded vs unbanded throughput + the
community-AUC quality gate vs the compiled C++ reference at matched
budget (the VERDICT #1 "done" criterion).

Graph: bench.make_youtube_graph -- the faithful power-law synthetic
(gamma~2.2, 1.1M vertices, ~2.94M links, 100 planted communities).

Run: python experiments/yt_scale_bench.py [perf|quality|ref]...
(GPU; default = perf quality)
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, "/root/repo")

from bench import REF_DIR, make_youtube_graph  # noqa: E402

YT = "/tmp/yt_faithful_net.txt"
N, N_COMM, SEED = 1_100_000, 100, 7
BUDGET = 40  # millions of samples for the quality gate


def labels():
    return np.random.default_rng(SEED).integers(0, N_COMM, N)


def community_auc(emb_by_vid, names, n_pairs=200_000, seed=0):
    """cos-similarity AUC: same-community pairs vs different."""
    lab_all = labels()
    vid_label = np.array([lab_all[int(nm[1:])] for nm in names])
    x = emb_by_vid / (np.linalg.norm(emb_by_vid, 1, keepdims=True) + 1e-9)
    x = emb_by_vid / (
        np.linalg.norm(emb_by_vid, axis=1, keepdims=True) + 1e-9
    )
    rng = np.random.default_rng(seed)
    a = rng.integers(0, len(x), n_pairs * 4)
    b = rng.integers(0, len(x), n_pairs * 4)
    same = vid_label[a] == vid_label[b]
    s = (x[a] * x[b]).sum(1)
    pos, neg = s[same][:n_pairs], s[~same][:n_pairs]
    n = min(len(pos), len(neg), n_pairs)
    pos, neg = pos[:n], neg[:n]
    return float((pos[:, None] > neg[None, :2000]).mean())


def train_ours(banded, sample_times, timed=True):
    from smore_tpu.graph.graph import Graph
    from smore_tpu.models.line import LINE

    g = Graph.load_edge_list(YT, undirected=True)
    m = LINE(g, seed=0)
    m.init(dim=64, order=2)
    m.train(sample_times=1, banded=banded, verbose=False)  # warm/compile
    float(m.state["vertex"][0, 0])
    t0 = time.time()
    m.train(sample_times=sample_times, banded=banded, verbose=False)
    float(m.state["vertex"][0, 0])
    dt = time.time() - t0
    rate = sample_times * 1e6 / dt
    print(f"banded={banded}: {rate/1e6:.2f} M samples/s "
          f"({sample_times}M in {dt:.1f}s)", flush=True)
    return m, rate


def run_reference():
    os.makedirs(REF_DIR, exist_ok=True)
    if not os.path.exists(os.path.join(REF_DIR, "cli", "line")):
        for d in ("src", "cli", "Makefile"):
            subprocess.run(["cp", "-r", f"/root/reference/{d}", REF_DIR],
                           check=True)
        subprocess.run(["make", "-C", REF_DIR], check=True,
                       capture_output=True)
    out = "/tmp/yt_ref_line.txt"
    t0 = time.time()
    subprocess.run(
        [os.path.join(REF_DIR, "cli", "line"), "-train", YT, "-save", out,
         "-order", "2", "-dimensions", "64", "-sample_times", str(BUDGET),
         "-negative_samples", "5", "-alpha", "0.025",
         "-threads", str(os.cpu_count() or 1)],
        check=True, capture_output=True)
    dt = time.time() - t0
    print(f"reference: {BUDGET*1e6/dt/1e6:.3f} M samples/s "
          f"({BUDGET}M in {dt:.1f}s, {os.cpu_count()} threads)", flush=True)
    # AUC by NAME from the saved file
    emb, names = [], []
    with open(out) as f:
        f.readline()
        for line in f:
            p = line.split()
            names.append(p[0])
            emb.append(np.array(p[1:], dtype=np.float32))
    auc = community_auc(np.stack(emb), names)
    print(f"reference community-AUC: {auc:.4f}", flush=True)


def main():
    make_youtube_graph(YT)
    want = sys.argv[1:] or ["perf", "quality"]
    if "ref" in want:
        run_reference()
    if "perf" in want:
        train_ours(banded=True, sample_times=100)
        train_ours(banded=False, sample_times=20)
    if "quality" in want:
        m, _ = train_ours(banded=True, sample_times=BUDGET, timed=False)
        auc = community_auc(np.asarray(m.state["vertex"]), m.graph.names)
        print(f"ours (banded) community-AUC @{BUDGET}M: {auc:.4f}",
              flush=True)


if __name__ == "__main__":
    main()
