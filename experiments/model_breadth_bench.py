"""Wall-clock breadth check: train several model families end-to-end on
the 50k-vertex bench graph on the GPU at reference-default-ish
configs, and report wall seconds + effective update rate. One process so
compiles are amortized/cached."""

from __future__ import annotations

import sys
import time

sys.path.insert(0, "/root/repo")

from bench import GRAPH_PATH, make_graph  # noqa: E402


def timed(tag, fn, units, unit_name):
    t0 = time.time()
    fn()
    dt = time.time() - t0
    print(f"{tag:28s} {dt:7.1f}s  ({units/dt/1e6:.1f}M {unit_name}/s)",
          flush=True)


def main():
    make_graph(GRAPH_PATH)
    from smore_tpu.graph.graph import Graph
    from smore_tpu.models.deepwalk import DeepWalk
    from smore_tpu.models.node2vec import Node2Vec
    from smore_tpu.models.hpe import HPE
    from smore_tpu.models.gcn import TextGCN  # noqa: F401  (import check)

    g = Graph.load_edge_list(GRAPH_PATH, undirected=True)
    n = g.n_vertices

    m = DeepWalk(g, seed=0)
    m.init(dim=64)
    m.train(walk_times=1, verbose=False)  # warm
    float(m.state["vertex"][0, 0])
    # 10 epochs x 50k walks x 40 steps x ~2*E[shrunken window] pairs
    pairs = 10 * n * 40 * 5  # approx with window 5 (shrunken mean ~2.5x2)
    timed("deepwalk walk_times=10", lambda: (
        m.train(walk_times=10, verbose=False),
        float(m.state["vertex"][0, 0]))[-1], pairs, "pairs")

    m2 = Node2Vec(g, seed=0, p=0.5, q=2.0)
    m2.init(dim=64)
    m2.train(walk_times=1, verbose=False)
    float(m2.state["vertex"][0, 0])
    timed("node2vec p=.5 q=2 wt=10", lambda: (
        m2.train(walk_times=10, verbose=False),
        float(m2.state["vertex"][0, 0]))[-1], pairs, "pairs")

    m3 = HPE(g, seed=0)
    m3.init(dim=64)
    m3.train(sample_times=1, verbose=False)
    float(m3.state["vertex"][0, 0])
    timed("hpe sample_times=10", lambda: (
        m3.train(sample_times=10, verbose=False),
        float(m3.state["vertex"][0, 0]))[-1], 10e6, "samples")


if __name__ == "__main__":
    main()
