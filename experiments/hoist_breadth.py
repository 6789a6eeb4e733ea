"""Measure the mega-draw hoist win for the rec and walk families on the
the GPU (50k bench graph): hoist=1 vs 8 vs 32 for BPR, and hoist=1 vs 8
for DeepWalk. Decides each family's default.

Run: python experiments/hoist_breadth.py
"""

from __future__ import annotations

import sys
import time

sys.path.insert(0, "/root/repo")

from bench import GRAPH_PATH, make_graph  # noqa: E402


def rate(fn, sync, units):
    t0 = time.time()
    fn()
    sync()
    return units / (time.time() - t0)


def main():
    make_graph(GRAPH_PATH)
    from smore_tpu.graph.graph import Graph
    from smore_tpu.models.deepwalk import DeepWalk
    from smore_tpu.models.rec import BPR

    g = Graph.load_edge_list(GRAPH_PATH, undirected=True)

    for hoist in (1, 8, 32):
        m = BPR(g, seed=0)
        m.init(dim=64)
        m.train(sample_times=1, hoist=hoist, verbose=False)  # warm
        float(m.state["vertex"][0, 0])
        r = rate(
            lambda: m.train(sample_times=40, hoist=hoist,
                            steps_per_call=1024, verbose=False),
            lambda: float(m.state["vertex"][0, 0]),
            40e6,
        )
        print(f"bpr   hoist={hoist:3d}  {r / 1e6:6.2f} M samples/s",
              flush=True)

    from smore_tpu.models.hpe import HPE

    for hoist in (1, 8):
        m = HPE(g, seed=0)
        m.init(dim=64)
        m.train(sample_times=1, hoist=hoist, verbose=False)
        float(m.state["vertex"][0, 0])
        r = rate(
            lambda: m.train(sample_times=20, hoist=hoist,
                            steps_per_call=512, verbose=False),
            lambda: float(m.state["vertex"][0, 0]),
            20e6,
        )
        print(f"hpe   hoist={hoist:3d}  {r / 1e6:6.2f} M samples/s",
              flush=True)

    for hoist in (1, 8):
        m = DeepWalk(g, seed=0)
        m.init(dim=64)
        m.train(walk_times=1, hoist=hoist, verbose=False)
        float(m.state["vertex"][0, 0])
        walks = 10 * g.n_vertices
        r = rate(
            lambda: m.train(walk_times=10, hoist=hoist, verbose=False),
            lambda: float(m.state["vertex"][0, 0]),
            walks,
        )
        # one 40-step walk yields <= 40*2*window/2 masked pair slots;
        # report walks/s (the schedule unit) to stay comparable
        print(f"dwalk hoist={hoist:3d}  {r / 1e3:6.1f} K walks/s",
              flush=True)


if __name__ == "__main__":
    main()
