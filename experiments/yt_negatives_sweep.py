"""Convergence vs shared-negative pool size at Youtube scale.

Reference LINE uses 5 FRESH negatives per sample (~164k negative-row
updates per 32768-sample step); our shared-negative matmul form uses one
Ks-row pool per step with k_equiv scaling. At the 40M gate that made no
difference (AUC 0.614 vs ref 0.611) but the converged-budget reference
arms (o2 0.813@120M / 0.965@400M) sit above the round-2 curve
(0.72@120M / 0.89@400M) -- hypothesis: negative-phase sparsity is the
convergence bottleneck mid-training.

Run: python experiments/yt_negatives_sweep.py [budgetM] [Ks ...]
"""

from __future__ import annotations

import sys
import time

import numpy as np

sys.path.insert(0, "/root/repo")

from bench import make_youtube_graph  # noqa: E402
from yt_scale_bench import YT, community_auc  # noqa: E402


def run(budget, ks, batch=0):
    from smore_tpu.graph.graph import Graph
    from smore_tpu.models.line import LINE

    g = Graph.load_edge_list(YT, undirected=True)
    m = LINE(g, seed=0)
    m.init(dim=64, order=2)
    kw = dict(banded=True, shared_negatives=ks, verbose=False)
    if batch:
        kw["batch"] = batch
    t0 = time.time()
    m.train(sample_times=budget, **kw)
    float(m.state["vertex"][0, 0])
    dt = time.time() - t0
    auc = community_auc(np.asarray(m.state["vertex"]), m.graph.names)
    print(f"Ks={ks} batch={batch or 'auto'} @{budget}M: AUC={auc:.4f} "
          f"({budget/dt:.1f} M samples/s)", flush=True)


def main():
    make_youtube_graph(YT)
    args = sys.argv[1:]
    budget = int(args[0]) if args else 120
    # "Ks" or "Ks:batch" arms
    arms = args[1:] or ["128", "512", "2048"]
    for arm in arms:
        if ":" in arm:
            ks, b = arm.split(":")
            run(budget, int(ks), batch=int(b))
        else:
            run(budget, int(arm))


if __name__ == "__main__":
    main()
