"""Temporal graph store + on-device time-increasing walks.

Reference: /root/reference/pkg/temporal/temporal_graph.go -- ``src dst
timestamp`` lines (:60-140), per-node edges sorted by time, and
TemporalRandomWalk (:225-251): each step picks UNIFORMLY among out-edges
with timestamp in (t_cur, t_cur + time_window], advancing t_cur to the
chosen edge's timestamp; the walk stops when no edge qualifies.

Device layout: out-edges flattened to (indptr, dst, ts) with per-node
timestamp-sorted segments; the in-window range [lo, hi) is found by two
fixed-iteration binary searches, the draw is one uniform.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclass
class TemporalGraph:
    names: List[str]
    name2id: Dict[str, int]
    indptr: np.ndarray  # (N+1,)
    edge_dst: np.ndarray  # (E,) sorted by (src, ts)
    edge_ts: np.ndarray  # (E,)
    active_min: np.ndarray  # (N,) min ts over in+out edges
    active_max: np.ndarray  # (N,)
    min_time: float
    max_time: float

    @property
    def n_vertices(self) -> int:
        return len(self.names)

    @property
    def n_edges(self) -> int:
        return len(self.edge_dst)

    def temporal_neighbors(self, vid: int, t0: float, t1: float) -> np.ndarray:
        """Out-neighbors of ``vid`` connected in [t0, t1] inclusive
        (temporal_graph.go GetTemporalNeighbors :181-195; edges are
        time-sorted per node, so this is two binary searches)."""
        lo, hi = self.indptr[vid], self.indptr[vid + 1]
        seg_ts = self.edge_ts[lo:hi]
        a = int(np.searchsorted(seg_ts, np.float32(t0), side="left"))
        b = int(np.searchsorted(seg_ts, np.float32(t1), side="right"))
        return self.edge_dst[lo + a:lo + b]

    def sample_temporal_neighbor(
        self, vid: int, t0: float, t1: float, rng: np.random.Generator
    ) -> Tuple[int, float]:
        """Uniform draw among in-window out-edges; (-1, 0.0) when none
        qualify (temporal_graph.go SampleTemporalNeighbor :198-210)."""
        lo, hi = self.indptr[vid], self.indptr[vid + 1]
        seg_ts = self.edge_ts[lo:hi]
        a = int(np.searchsorted(seg_ts, np.float32(t0), side="left"))
        b = int(np.searchsorted(seg_ts, np.float32(t1), side="right"))
        if b <= a:
            return -1, 0.0
        j = lo + a + int(rng.integers(0, b - a))
        return int(self.edge_dst[j]), float(self.edge_ts[j])

    @staticmethod
    def load_edge_list(path: str) -> "TemporalGraph":
        name2id: Dict[str, int] = {}
        names: List[str] = []
        src_l, dst_l, ts_l = [], [], []

        def intern(s):
            i = name2id.get(s)
            if i is None:
                i = len(names)
                name2id[s] = i
                names.append(s)
            return i

        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 3:
                    continue
                try:
                    ts = float(parts[2])
                except ValueError:
                    continue
                src_l.append(intern(parts[0]))
                dst_l.append(intern(parts[1]))
                ts_l.append(ts)

        n = len(names)
        src = np.asarray(src_l, dtype=np.int64)
        dst = np.asarray(dst_l, dtype=np.int64)
        ts = np.asarray(ts_l, dtype=np.float64)
        order = np.lexsort((ts, src))
        src, dst, ts = src[order], dst[order], ts[order]
        counts = np.bincount(src, minlength=n)
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])

        amin = np.full(n, np.inf)
        amax = np.full(n, -np.inf)
        np.minimum.at(amin, src, ts)
        np.maximum.at(amax, src, ts)
        np.minimum.at(amin, dst, ts)
        np.maximum.at(amax, dst, ts)
        amin[~np.isfinite(amin)] = 0.0
        amax[~np.isfinite(amax)] = 0.0

        return TemporalGraph(
            names=names,
            name2id=name2id,
            indptr=indptr,
            edge_dst=dst.astype(np.int32),
            edge_ts=ts.astype(np.float32),
            active_min=amin.astype(np.float32),
            active_max=amax.astype(np.float32),
            min_time=float(ts.min()) if len(ts) else 0.0,
            max_time=float(ts.max()) if len(ts) else 0.0,
        )


@jax.tree_util.register_pytree_node_class
class TemporalTables:
    """Device arrays for temporal walks."""

    def __init__(self, indptr, edge_dst, edge_ts, active_min, active_max,
                 max_time, n_iters: int):
        self.indptr = indptr
        self.edge_dst = edge_dst
        self.edge_ts = edge_ts
        self.active_min = active_min
        self.active_max = active_max
        self.max_time = max_time
        self.n_iters = n_iters

    def tree_flatten(self):
        return (
            self.indptr, self.edge_dst, self.edge_ts,
            self.active_min, self.active_max, self.max_time,
        ), self.n_iters

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, aux)

    @staticmethod
    def build(tg: TemporalGraph) -> "TemporalTables":
        max_deg = (
            int(np.max(np.diff(tg.indptr))) if tg.n_vertices else 1
        )
        n_iters = max(1, int(np.ceil(np.log2(max(max_deg, 2)))) + 1)
        return TemporalTables(
            jnp.asarray(tg.indptr, dtype=jnp.int32),
            jnp.asarray(tg.edge_dst),
            jnp.asarray(tg.edge_ts),
            jnp.asarray(tg.active_min),
            jnp.asarray(tg.active_max),
            jnp.float32(tg.max_time),
            n_iters,
        )

    def _seg_searchsorted(self, lo, hi, t):
        """First index in [lo, hi) with edge_ts > t (right bisect)."""
        e = self.edge_ts.shape[0]
        for _ in range(self.n_iters):
            mid = (lo + hi) // 2
            val = self.edge_ts.at[jnp.minimum(mid, e - 1)].get(
                mode="promise_in_bounds"
            )
            go_right = (val <= t) & (mid < hi)
            lo = jnp.where(go_right, mid + 1, lo)
            hi = jnp.where(go_right, hi, mid)
        return lo

    def temporal_walk(
        self,
        key: jax.Array,
        starts: jnp.ndarray,  # (B,)
        start_times: jnp.ndarray,  # (B,)
        steps: int,
        time_window: float,
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Batched TemporalRandomWalk. Returns (walk (B, steps+1),
        valid (B, steps+1) -- 1 while the walk is alive)."""
        B = starts.shape[0]
        u = jax.random.uniform(key, (steps, B))

        def body(carry, u_t):
            cur, t, alive = carry
            lo0 = self.indptr.at[cur].get(mode="promise_in_bounds")
            hi0 = self.indptr.at[cur + 1].get(mode="promise_in_bounds")
            lo = self._seg_searchsorted(lo0, hi0, t)
            end = jnp.minimum(t + time_window, self.max_time)
            hi = self._seg_searchsorted(lo0, hi0, end)
            size = hi - lo
            ok = (size > 0) & alive
            slot = lo + jnp.minimum(
                (u_t * jnp.maximum(size, 1)).astype(jnp.int32),
                jnp.maximum(size - 1, 0),
            )
            nxt = self.edge_dst.at[slot].get(mode="promise_in_bounds")
            nts = self.edge_ts.at[slot].get(mode="promise_in_bounds")
            cur = jnp.where(ok, nxt, cur)
            t = jnp.where(ok, nts, t)
            return (cur, t, ok), (cur, ok)

        alive0 = jnp.ones((B,), dtype=bool)
        (_, _, _), (path, ok) = jax.lax.scan(
            body, (starts, start_times, alive0), u
        )
        walk = jnp.concatenate([starts[None], path], axis=0)
        valid = jnp.concatenate([alive0[None], ok], axis=0)
        return (
            jnp.swapaxes(walk, 0, 1),
            jnp.swapaxes(valid, 0, 1).astype(jnp.float32),
        )
