"""Step-time comparison: DP (replicated tables, psum of full (N,D)
deltas) vs rows (row-sharded tables, GSPMD collectives) vs single-device,
on the virtual 8-device CPU mesh.

CPU-mesh timings are not representative of NVLink, but they expose the traffic
scaling: DP's per-step psum moves the whole (N, D) table delta, so its
step time grows with N; rows moves O(batch * D) rows. Run:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python experiments/rowshard_bench.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault(
    "XLA_FLAGS",
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8",
)

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

from smore_tpu.graph.graph import Graph
from smore_tpu.models.line import LINE
from smore_tpu.parallel.mesh import make_mesh


def make_graph(n_vertices: int, n_edges: int, seed: int = 0) -> Graph:
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_vertices, n_edges)
    dst = rng.integers(0, n_vertices, n_edges)
    keep = src != dst
    names = [f"v{i}" for i in range(n_vertices)]
    return Graph.from_arrays(
        src[keep], dst[keep], np.ones(int(keep.sum())),
        names, {s: i for i, s in enumerate(names)},
    )


def timed_run(g, mesh, sharding, dim=64, batch=4096, calls=6,
              steps_per_call=16):
    m = LINE(g, seed=0)
    m.init(dim=dim, order=2)
    kw = dict(
        negative_samples=5, alpha=0.02, batch=batch,
        steps_per_call=steps_per_call, group=1, shared_negatives=128,
        verbose=False,
    )
    if mesh is not None:
        kw.update(mesh=mesh, sharding=sharding)
    spc = batch * steps_per_call
    # warmup/compile: 1 call
    m.train(sample_times=spc / 1e6, **kw)
    t0 = time.time()
    m.train(sample_times=calls * spc / 1e6, **kw)
    el = time.time() - t0
    return el / calls / steps_per_call * 1e3  # ms per step


def main():
    mesh = make_mesh(min(8, len(jax.devices())))
    print(f"devices: {len(jax.devices())}, mesh: {mesh.devices.shape}")
    print(f"{'n_vertices':>10} {'single ms':>10} {'dp ms':>10} {'rows ms':>10}")
    sizes = [int(a) for a in sys.argv[1:]] or [20_000, 100_000, 400_000]
    for n in sizes:
        # fewer timed calls at the 1.1M scale (absolute CPU-mesh time is
        # not the point; the scaling row is)
        calls = 3 if n > 500_000 else 6
        g = make_graph(n, 4 * n)
        single = timed_run(g, None, None, calls=calls)
        dp = timed_run(g, mesh, "dp", calls=calls)
        rows = timed_run(g, mesh, "rows", calls=calls)
        print(f"{n:>10} {single:>10.2f} {dp:>10.2f} {rows:>10.2f}", flush=True)


if __name__ == "__main__":
    main()
