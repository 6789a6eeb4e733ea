"""Does degree-descending vertex relabeling speed up training at large N?

Hypothesis: random-row gathers/scatters dominate the step; hub vertices
are touched most often (draws are degree-weighted), so packing hot rows
into a contiguous low-index region should improve HBM locality. Tests
LINE o2 on the 1.1M-vertex synthetic graph with identity vs
degree-sorted labelings. Run on the GPU.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, "/root/repo")

YT_PATH = "/tmp/yt_scale_net.txt"


def relabel_by_degree(g):
    """Return a structurally identical Graph whose vids are assigned in
    descending (in+out)-degree order."""
    from smore_tpu.graph.graph import Graph

    deg = g.out_degree + g.in_degree
    order = np.argsort(-deg, kind="stable")  # new position -> old vid
    new_of_old = np.empty_like(order)
    new_of_old[order] = np.arange(len(order))
    src_old = np.repeat(np.arange(g.n_vertices), np.diff(g.indptr))
    src, dst = new_of_old[src_old], new_of_old[g.indices]
    names = [g.names[o] for o in order]
    name2id = {s: i for i, s in enumerate(names)}
    return Graph.from_arrays(src, dst, g.weights, names, name2id)


def run(g, tag):
    from smore_tpu.models.line import LINE

    m = LINE(g, seed=0)
    m.init(dim=64, order=2)
    m.train(sample_times=1, verbose=False)
    float(m.state["vertex"][0, 0])
    t0 = time.time()
    m.train(sample_times=40, verbose=False)
    float(m.state["vertex"][0, 0])
    dt = time.time() - t0
    print(f"{tag}: {40/dt:.2f} M samples/s", flush=True)


def main():
    from smore_tpu.graph.graph import Graph

    assert os.path.exists(YT_PATH), "run experiments/microf1_scale.py first"
    g = Graph.load_edge_list(YT_PATH, undirected=True)
    run(g, "identity labeling")
    run(relabel_by_degree(g), "degree-desc labeling")


if __name__ == "__main__":
    main()
