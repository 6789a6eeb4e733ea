"""Band-persistent superstep measurement at Youtube scale (VERDICT r2
item 2): throughput of band_hold ON vs OFF at several hold (=hoist)
factors, and the 40M community-AUC quality gate for the held config.

Run on the GPU: python experiments/band_hold_bench.py [perf|quality]
"""

from __future__ import annotations

import sys
import time

import numpy as np

sys.path.insert(0, "/root/repo")

from bench import make_youtube_graph  # noqa: E402
from yt_scale_bench import YT, community_auc  # noqa: E402


def run(hold_on, hoist, sample_times, quality=False):
    from smore_tpu.graph.graph import Graph
    from smore_tpu.models.line import LINE

    g = Graph.load_edge_list(YT, undirected=True)
    m = LINE(g, seed=0)
    m.init(dim=64, order=2)
    kw = dict(banded=True, band_hold=hold_on, hoist=hoist, verbose=False)
    m.train(sample_times=1, **kw)
    float(m.state["vertex"][0, 0])
    t0 = time.time()
    m.train(sample_times=sample_times, **kw)
    float(m.state["vertex"][0, 0])
    dt = time.time() - t0
    print(f"hold={hold_on} hoist={hoist} @{sample_times}M: "
          f"{sample_times/dt:.2f} M samples/s ({dt:.1f}s)", flush=True)
    if quality:
        auc = community_auc(np.asarray(m.state["vertex"]), m.graph.names)
        print(f"  -> community-AUC @{sample_times}M: {auc:.4f}", flush=True)


def main():
    make_youtube_graph(YT)
    want = sys.argv[1:] or ["perf", "quality"]
    if "perf" in want:
        run(False, 8, 100)
        run(True, 8, 100)
        run(True, 16, 100)
        run(True, 32, 100)
    if "quality" in want:
        run(True, 8, 40, quality=True)
        run(True, 32, 40, quality=True)


if __name__ == "__main__":
    main()
