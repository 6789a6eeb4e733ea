"""Heterogeneous (typed-node) graph store + on-device metapath walks.

Reference: /root/reference/pkg/hetero/hetero_graph.go -- file format
``src srcType dst dstType edgeType [weight]`` (:60-137), per-node
neighbor lists indexed by type (:169-182), uniform typed-neighbor
sampling (:207-219), and MetaPathWalk (:221-257): follow the type
sequence cyclically, stop on type mismatch or missing typed neighbor.

Device layout: neighbors sorted by (src, dst_type) into one flat array;
(node, type) segments addressed via a (N*T+1,) indptr, so a typed
neighbor draw is one uniform inside the segment.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclass
class HeteroGraph:
    names: List[str]
    name2id: Dict[str, int]
    types: List[str]
    type2id: Dict[str, int]
    node_type: np.ndarray  # (N,) int32
    nbr_indptr: np.ndarray  # (N*T+1,) int64 -- segment (node*T + type)
    nbr_flat: np.ndarray  # (E,) int32 neighbors sorted by (src, type)

    @property
    def n_vertices(self) -> int:
        return len(self.names)

    @property
    def n_types(self) -> int:
        return len(self.types)

    def nodes_of_type(self, t: str) -> np.ndarray:
        tid = self.type2id[t]
        return np.nonzero(self.node_type == tid)[0]

    def neighbors_by_type(self, vid: int, t: str) -> np.ndarray:
        """Neighbors of ``vid`` whose node type is ``t`` (hetero_graph.go:169-182).
        Unknown type names yield an empty array (reference map-miss semantics)."""
        tid = self.type2id.get(t)
        if tid is None:
            return self.nbr_flat[:0]
        seg = vid * self.n_types + tid
        return self.nbr_flat[self.nbr_indptr[seg]:self.nbr_indptr[seg + 1]]

    def neighbor_count(self, vid: int, t: str) -> int:
        """Count of typed neighbors (hetero_graph.go GetNeighborCount);
        0 for a type name not present in the graph."""
        tid = self.type2id.get(t)
        if tid is None:
            return 0
        seg = vid * self.n_types + tid
        return int(self.nbr_indptr[seg + 1] - self.nbr_indptr[seg])

    def validate_meta_path(self, meta_path: List[str]) -> None:
        """Raise ValueError on an invalid metapath: fewer than 2 types, or a
        type name unknown to the graph (hetero_graph.go:260-272)."""
        if len(meta_path) < 2:
            raise ValueError("meta-path must have at least 2 types")
        for t in meta_path:
            if t not in self.type2id:
                raise ValueError(f"unknown node type in meta-path: {t}")

    @staticmethod
    def load_edge_list(path: str, undirected: bool = True) -> "HeteroGraph":
        name2id: Dict[str, int] = {}
        names: List[str] = []
        type2id: Dict[str, int] = {}
        types: List[str] = []
        ntype: List[int] = []
        src_l, dst_l = [], []

        def intern_type(s):
            i = type2id.get(s)
            if i is None:
                i = len(types)
                type2id[s] = i
                types.append(s)
            return i

        def intern(nm, tp):
            i = name2id.get(nm)
            if i is None:
                i = len(names)
                name2id[nm] = i
                names.append(nm)
                ntype.append(intern_type(tp))
            return i

        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 5:
                    continue
                a = intern(parts[0], parts[1])
                b = intern(parts[2], parts[3])
                src_l.append(a)
                dst_l.append(b)
                if undirected:
                    src_l.append(b)
                    dst_l.append(a)

        n, t = len(names), len(types)
        node_type = np.asarray(ntype, dtype=np.int32)
        src = np.asarray(src_l, dtype=np.int64)
        dst = np.asarray(dst_l, dtype=np.int64)
        seg = src * t + node_type[dst]
        order = np.argsort(seg, kind="stable")
        seg_s, dst_s = seg[order], dst[order]
        indptr = np.searchsorted(seg_s, np.arange(n * t + 1)).astype(np.int64)
        return HeteroGraph(
            names=names,
            name2id=name2id,
            types=types,
            type2id=type2id,
            node_type=node_type,
            nbr_indptr=indptr,
            nbr_flat=dst_s.astype(np.int32),
        )


@jax.tree_util.register_pytree_node_class
class HeteroTables:
    def __init__(self, node_type, nbr_indptr, nbr_flat, n_types: int):
        self.node_type = node_type
        self.nbr_indptr = nbr_indptr
        self.nbr_flat = nbr_flat
        self.n_types = n_types

    def tree_flatten(self):
        return (self.node_type, self.nbr_indptr, self.nbr_flat), self.n_types

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, aux)

    @staticmethod
    def build(hg: HeteroGraph) -> "HeteroTables":
        return HeteroTables(
            jnp.asarray(hg.node_type),
            jnp.asarray(hg.nbr_indptr, dtype=jnp.int32),
            jnp.asarray(hg.nbr_flat),
            hg.n_types,
        )

    def typed_neighbor(self, u, vids, ttypes):
        """Uniform neighbor of type ttypes[i] for each vids[i]; returns
        (nbr, ok). ``u`` is a (B,) uniform tensor."""
        seg = vids * self.n_types + ttypes
        lo = self.nbr_indptr.at[seg].get(mode="promise_in_bounds")
        hi = self.nbr_indptr.at[seg + 1].get(mode="promise_in_bounds")
        size = hi - lo
        ok = size > 0
        slot = lo + jnp.minimum(
            (u * jnp.maximum(size, 1)).astype(jnp.int32),
            jnp.maximum(size - 1, 0),
        )
        return self.nbr_flat.at[slot].get(mode="promise_in_bounds"), ok

    def metapath_walk(
        self,
        key: jax.Array,
        starts: jnp.ndarray,  # (B,)
        path_types: jnp.ndarray,  # (P, Lmax) int32 type ids, padded
        path_lens: jnp.ndarray,  # (P,) int32
        path_idx: jnp.ndarray,  # (B,) which metapath each walk follows
        steps: int,
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Batched MetaPathWalk. Returns (walk (B, steps+1), valid)."""
        B = starts.shape[0]
        u = jax.random.uniform(key, (steps, B))
        plen = path_lens.at[path_idx].get(mode="promise_in_bounds")
        # the walk dies immediately if the start's type != path[0]
        t0 = path_types.at[path_idx, 0].get(mode="promise_in_bounds")
        alive0 = (
            self.node_type.at[starts].get(mode="promise_in_bounds") == t0
        )

        def body(carry, inp):
            cur, alive, pidx = carry
            s, u_t = inp
            next_t = path_types.at[
                path_idx, jnp.mod(pidx + 1, plen)
            ].get(mode="promise_in_bounds")
            nbr, ok = self.typed_neighbor(u_t, cur, next_t)
            ok = ok & alive
            cur = jnp.where(ok, nbr, cur)
            return (cur, ok, pidx + 1), (cur, ok)

        steps_idx = jnp.arange(steps)
        (_, _, _), (path, ok) = jax.lax.scan(
            body,
            (starts, alive0, jnp.zeros((B,), dtype=jnp.int32)),
            (steps_idx, u),
        )
        walk = jnp.concatenate([starts[None], path], axis=0)
        valid = jnp.concatenate([alive0[None], ok], axis=0)
        return (
            jnp.swapaxes(walk, 0, 1),
            jnp.swapaxes(valid, 0, 1).astype(jnp.float32),
        )
