"""Sampler tables: host-built alias tables packaged as device arrays,
with on-device batched draw functions.

Replaces the reference's per-sample O(1) CPU draws
(proNet::SourceSample/TargetSample/NegativeSample,
/root/reference/src/proNet.cpp:623-683) with batched gathers that run
inside the jitted training step on the device. A draw is:

    i ~ U{0..n-1};  u ~ U[0,1);  out = where(u < prob[i], value[i], alias[i])

i.e. two gathers + a select, fully vectorized over the batch.

Method strings mirror the reference (proNet.cpp:456-510):
  vertex_method  in {"out_degrees", "no_degrees", "degrees"}
  negative_method in {"degrees", "in_degrees", "no_degrees"}
All tables are 0.75-power transformed (see smore_tpu/sampling/alias.py on
the reference's POWER_SAMPLE quirk).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from smore_tpu.graph.graph import Graph
from smore_tpu.sampling.alias import build_alias, build_alias_segmented


def _vertex_distribution(g: Graph, method: str) -> np.ndarray:
    if method == "out_degrees":
        return g.out_degree
    if method == "no_degrees":
        return (g.out_degree > 0).astype(np.float64)
    if method == "degrees":
        return g.out_degree + g.in_degree
    raise ValueError(f"unknown vertex_method {method!r}")


def _negative_distribution(g: Graph, method: str) -> np.ndarray:
    if method == "degrees":
        return g.out_degree + g.in_degree
    if method == "in_degrees":
        return g.in_degree
    if method == "no_degrees":
        return (g.in_degree > 0).astype(np.float64)
    raise ValueError(f"unknown negative_method {method!r}")


@jax.tree_util.register_pytree_node_class
@dataclass
class SamplerTables:
    """Device-resident alias tables for a weighted graph.

    Arrays (all jnp, device-resident):
      vertex_prob/vertex_alias : (N,)  source-vertex table
      neg_prob/neg_alias       : (N,)  negative table (deg^0.75)
      indptr                   : (N+1,) int32 CSR offsets
      degree                   : (N,) int32 out-branch count
      ctx_prob                 : (E,) per-vertex context sub-tables, flat
      ctx_vid                  : (E,) int32 vid at each context slot
      ctx_alias_vid            : (E,) int32 alias vid at each slot
                                 (pre-remapped, proNet.cpp:528-534 analog)
    """

    vertex_prob: jnp.ndarray
    vertex_alias: jnp.ndarray
    neg_prob: jnp.ndarray
    neg_alias: jnp.ndarray
    indptr: jnp.ndarray
    degree: jnp.ndarray
    ctx_prob: jnp.ndarray
    ctx_vid: jnp.ndarray
    ctx_alias_vid: jnp.ndarray
    # Packed layouts for fast draws: one row-gather yields every field a
    # draw needs (1-D gathers of separate arrays are several times slower
    # on the device). Alias vids are stored as float32 -- exact for vid < 2^24.
    #   vertex_pa: (N, 2) [prob, alias]
    #   neg_pa:    (N, 2) [prob, alias]
    #   vert_meta: (N, 2) int32 [indptr, degree]
    #   ctx_pa:    (E, 4) [prob, vid, alias_vid, 0]
    vertex_pa: jnp.ndarray
    neg_pa: jnp.ndarray
    vert_meta: jnp.ndarray
    ctx_pa: jnp.ndarray
    # Joint EDGE alias table: one O(1) draw yields a (src, pos) pair with
    # EXACTLY the two-stage law P(src) * P(pos | src) -- the slot weight is
    # p_vertex(u) * w_uv^0.75 / Z_u, precomputed on host. Collapses the
    # dependent gather chain source_sample -> vert_meta -> ctx_pa (three
    # random row reads) into ONE row read.
    #   edge_pa: (E, 8) [prob, src, dst, alias_src, alias_dst, 0, 0, 0]
    # vids stored as float32 (exact below 2^24; build() falls back to a
    # (1, 8) dummy above that, and draw_edge_batch uses the 2-stage path).
    edge_pa: jnp.ndarray

    # -- pytree protocol (so the tables can be passed to jit as an arg) --
    def tree_flatten(self):
        children = (
            self.vertex_prob,
            self.vertex_alias,
            self.neg_prob,
            self.neg_alias,
            self.indptr,
            self.degree,
            self.ctx_prob,
            self.ctx_vid,
            self.ctx_alias_vid,
            self.vertex_pa,
            self.neg_pa,
            self.vert_meta,
            self.ctx_pa,
            self.edge_pa,
        )
        return children, None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def n_vertices(self) -> int:
        return self.vertex_prob.shape[0]

    @property
    def n_edges(self) -> int:
        return self.ctx_prob.shape[0]

    # ------------------------------------------------------------------ #
    @staticmethod
    def build_negative_table(
        g: Graph, negative_method: str = "degrees", power: float = 0.75
    ) -> jnp.ndarray:
        """Just the (N, 2) [prob, alias] negative alias table -- for
        consumers (e.g. BandedTables) that need ONLY the negative law
        and shouldn't pay HBM for the full sampler."""
        np_, na = build_alias(
            _negative_distribution(g, negative_method), power=power
        )
        idx = np.arange(g.n_vertices, dtype=np.int64)
        na_safe = np.where(na < 0, idx, na)
        return jnp.asarray(
            np.stack([np_, na_safe], axis=1).astype(np.float32)
        )

    @staticmethod
    def build(
        g: Graph,
        vertex_method: str = "out_degrees",
        negative_method: str = "degrees",
        power: float = 0.75,
    ) -> "SamplerTables":
        n = g.n_vertices

        vp, va = build_alias(_vertex_distribution(g, vertex_method), power=power)
        np_, na = build_alias(_negative_distribution(g, negative_method), power=power)

        # Per-vertex context sub-tables over outgoing edge weights.
        cp, ca_local = build_alias_segmented(g.weights, g.indptr, power=power)
        # Remap local alias slot -> vid (reference proNet.cpp:528-534);
        # -1 (prob==1) slots map to their own vid.
        seg_id = np.repeat(np.arange(n, dtype=np.int64), np.diff(g.indptr))
        base = g.indptr[seg_id]
        slot = np.arange(g.n_edges, dtype=np.int64)
        alias_slot = np.where(ca_local >= 0, base + ca_local, slot)
        ctx_alias_vid = g.indices[alias_slot]

        def dev(x, dt):
            return jnp.asarray(np.asarray(x, dtype=dt))

        idx = np.arange(n, dtype=np.int64)
        va_safe = np.where(va < 0, idx, va)
        na_safe = np.where(na < 0, idx, na)
        deg = np.diff(g.indptr)

        # Joint edge table (see field docs). Only exact while vids fit in
        # a float32 mantissa AND the slot index u*E stays unquantized
        # (u is a float32 uniform with 2^24 distinct values); degenerate
        # (1,8) dummy otherwise (dynamic paths fall back to two-stage).
        if 0 < g.n_edges < (1 << 24) and n < (1 << 24):
            vmass = _vertex_distribution(g, vertex_method).astype(np.float64)
            vmass = np.where(vmass > 0, vmass**power, 0.0)
            w_pow = np.asarray(g.weights, dtype=np.float64)
            w_pow = np.where(w_pow > 0, w_pow**power, 0.0)
            z = np.bincount(seg_id, weights=w_pow, minlength=n)
            joint = (vmass[seg_id] / max(vmass.sum(), 1e-300)) * (
                w_pow / np.maximum(z[seg_id], 1e-300)
            )
            eprob, ealias = build_alias(joint, power=1.0)
            ea_safe = np.where(ealias < 0, slot, ealias)
            edge_pa_np = np.zeros((g.n_edges, 8), dtype=np.float32)
            edge_pa_np[:, 0] = eprob
            edge_pa_np[:, 1] = seg_id
            edge_pa_np[:, 2] = g.indices
            edge_pa_np[:, 3] = seg_id[ea_safe]
            edge_pa_np[:, 4] = g.indices[ea_safe]
        else:
            edge_pa_np = np.zeros((1, 8), dtype=np.float32)
        return SamplerTables(
            vertex_prob=dev(vp, np.float32),
            vertex_alias=dev(va_safe, np.int32),
            neg_prob=dev(np_, np.float32),
            neg_alias=dev(na_safe, np.int32),
            indptr=dev(g.indptr, np.int32),
            degree=dev(deg, np.int32),
            ctx_prob=dev(cp, np.float32),
            ctx_vid=dev(g.indices, np.int32),
            ctx_alias_vid=dev(ctx_alias_vid, np.int32),
            vertex_pa=dev(np.stack([vp, va_safe], axis=1), np.float32),
            neg_pa=dev(np.stack([np_, na_safe], axis=1), np.float32),
            vert_meta=dev(np.stack([g.indptr[:-1], deg], axis=1), np.int32),
            ctx_pa=dev(
                np.stack(
                    [cp, g.indices, ctx_alias_vid, np.zeros(g.n_edges)], axis=1
                ),
                np.float32,
            ),
            edge_pa=dev(edge_pa_np, np.float32),
        )

    # ------------------------------------------------------------------ #
    # On-device batched draws. All take a PRNG key and a static shape and
    # are safe to call inside jit / scan / shard_map.
    # ------------------------------------------------------------------ #
    def source_sample(
        self, key: jax.Array, shape, u2: Optional[jnp.ndarray] = None
    ) -> jnp.ndarray:
        """Batched proNet::SourceSample (proNet.cpp:647-657).

        Optionally takes pre-generated uniforms ``u2`` of shape (*shape, 2)
        so callers can batch all RNG for a step into one call."""
        if u2 is None:
            u2 = jax.random.uniform(key, tuple(shape) + (2,))
        n = self.vertex_pa.shape[0]
        i = jnp.minimum((u2[..., 0] * n).astype(jnp.int32), n - 1)
        row = self.vertex_pa.at[i].get(mode="promise_in_bounds")
        return jnp.where(
            u2[..., 1] < row[..., 0], i, row[..., 1].astype(jnp.int32)
        )

    def negative_sample(
        self, key: jax.Array, shape, u2: Optional[jnp.ndarray] = None
    ) -> jnp.ndarray:
        """Batched proNet::NegativeSample (proNet.cpp:623-633)."""
        if u2 is None:
            u2 = jax.random.uniform(key, tuple(shape) + (2,))
        n = self.neg_pa.shape[0]
        i = jnp.minimum((u2[..., 0] * n).astype(jnp.int32), n - 1)
        row = self.neg_pa.at[i].get(mode="promise_in_bounds")
        return jnp.where(
            u2[..., 1] < row[..., 0], i, row[..., 1].astype(jnp.int32)
        )

    def target_sample(
        self,
        key: jax.Array,
        vids: jnp.ndarray,
        u2: Optional[jnp.ndarray] = None,
    ) -> jnp.ndarray:
        """Batched proNet::TargetSample(vid) (proNet.cpp:671-683):
        draw one out-neighbor per vid, weighted by edge weight^0.75.

        Zero-degree vids return themselves (callers mask; the reference
        returns -1 and callers restart the walk)."""
        if u2 is None:
            u2 = jax.random.uniform(key, tuple(vids.shape) + (2,))
        meta = self.vert_meta.at[vids].get(mode="promise_in_bounds")
        off, deg = meta[..., 0], meta[..., 1]
        r = (u2[..., 0] * deg).astype(jnp.int32)  # in [0, deg)
        slot = off + jnp.minimum(r, jnp.maximum(deg - 1, 0))
        row = self.ctx_pa.at[slot].get(mode="promise_in_bounds")
        out = jnp.where(u2[..., 1] < row[..., 0], row[..., 1], row[..., 2])
        return jnp.where(deg > 0, out.astype(jnp.int32), vids)

    def target_sample_global(
        self, key: jax.Array, shape, u2: Optional[jnp.ndarray] = None
    ) -> jnp.ndarray:
        """Batched proNet::TargetSample() over all edge slots
        (proNet.cpp:659-669): uniform over edge slots, corrected by the
        per-vertex sub-table (the reference's concatenated-table draw)."""
        if u2 is None:
            u2 = jax.random.uniform(key, tuple(shape) + (2,))
        e = self.ctx_pa.shape[0]
        slot = jnp.minimum((u2[..., 0] * e).astype(jnp.int32), e - 1)
        row = self.ctx_pa.at[slot].get(mode="promise_in_bounds")
        out = jnp.where(u2[..., 1] < row[..., 0], row[..., 1], row[..., 2])
        return out.astype(jnp.int32)

    def edge_sample(
        self, key: jax.Array, shape, u2: Optional[jnp.ndarray] = None
    ):
        """One O(1) draw of a (src, pos) pair from the joint edge table --
        identical in law to source_sample followed by target_sample(src)
        (see edge_pa field docs). Requires the table to have been built
        (n_vertices < 2^24)."""
        if u2 is None:
            u2 = jax.random.uniform(key, tuple(shape) + (2,))
        e = self.edge_pa.shape[0]
        i = jnp.minimum((u2[..., 0] * e).astype(jnp.int32), e - 1)
        row = self.edge_pa.at[i].get(mode="promise_in_bounds")
        take = u2[..., 1] < row[..., 0]
        src = jnp.where(take, row[..., 1], row[..., 3])
        dst = jnp.where(take, row[..., 2], row[..., 4])
        return src.astype(jnp.int32), dst.astype(jnp.int32)

    @property
    def has_edge_table(self) -> bool:
        return self.edge_pa.shape[0] > 1

    def draw_edge_batch(self, key: jax.Array, batch: int, n_negs: int):
        """Draw (src, pos, negs) for one SGNS step with a single RNG call:
        (src, pos) jointly from the edge table when built (one gather),
        else src ~ vertex table then pos ~ src's context sub-table; negs ~
        negative table. Shapes (batch,), (batch,), (n_negs,) [shared
        negatives]."""
        if self.has_edge_table:
            u = jax.random.uniform(key, (batch, 4))
            src, pos = self.edge_sample(key, (batch,), u2=u[:, 0:2])
            negs = self.negative_sample(key, (n_negs,), u2=u[:n_negs, 2:4])
            return src, pos, negs
        u = jax.random.uniform(key, (batch, 6))
        src = self.source_sample(key, (batch,), u2=u[:, 0:2])
        pos = self.target_sample(key, src, u2=u[:, 2:4])
        negs = self.negative_sample(key, (n_negs,), u2=u[:n_negs, 4:6])
        return src, pos, negs

    def draw_edge_batches_hoisted(
        self, key: jax.Array, batch: int, group: int, n_negs: int, steps: int
    ):
        """Mega-draw for ``steps`` consecutive grouped edge batches in ONE
        shot. Identical in law to ``steps`` independent
        draw_edge_batch_grouped calls: draws are state-independent, so
        hoisting them out of the update scan changes nothing about the
        sampling distribution. Two wins: the per-row gather fixed costs amortize over steps*batch
        rows, and the per-vertex meta gather runs at the small
        (total//group,) source size and is jnp.repeat-ed (identical by
        composition: vert_meta is a pure function of src).

        Returns (src, pos, negs) shaped (steps, batch), (steps, batch),
        (steps, n_negs); row i is step i's batch (groups of ``group``
        consecutive elements share a source, as in the per-step draw).
        Requires the edge table and batch % group == 0."""
        total = batch * steps
        bg = total // group
        u = jax.random.uniform(key, (total, 4))
        src_small, pos0 = self.edge_sample(key, (bg,), u2=u[:bg, 0:2])
        src = jnp.repeat(src_small, group)
        meta = self.vert_meta.at[src_small].get(mode="promise_in_bounds")
        meta = jnp.repeat(meta, group, axis=0)
        off, deg = meta[:, 0], meta[:, 1]
        u2 = u[:, 2:4]
        r = (u2[:, 0] * deg).astype(jnp.int32)
        slot = off + jnp.minimum(r, jnp.maximum(deg - 1, 0))
        row = self.ctx_pa.at[slot].get(mode="promise_in_bounds")
        out = jnp.where(u2[:, 1] < row[:, 0], row[:, 1], row[:, 2])
        pos = jnp.where(deg > 0, out.astype(jnp.int32), src)
        pos = pos.at[::group].set(pos0)
        nt = n_negs * steps
        if bg + nt <= total:
            # rows bg.. of cols 0:2 are unused by the edge draw
            u_neg = u[bg : bg + nt, 0:2]
        else:
            u_neg = jax.random.uniform(jax.random.fold_in(key, 1), (nt, 2))
        negs = self.negative_sample(key, (nt,), u2=u_neg)
        return (
            src.reshape(steps, batch),
            pos.reshape(steps, batch),
            negs.reshape(steps, n_negs),
        )

    def draw_edge_batch_grouped(
        self, key: jax.Array, batch: int, group: int, n_negs: int
    ):
        """Grouped edge draw: batch//group (src, pos_0) pairs from the
        joint edge table, then group-1 extra contexts per source via the
        per-vertex sub-table. src comes back in repeat layout
        (``jnp.repeat(src_small, group)``) so the source side can be
        segment-summed in-register (ops.update.sgns_shared_negs_step
        ``src_group``). Requires the edge table (has_edge_table)."""
        bg = batch // group
        u = jax.random.uniform(key, (batch, 4))
        src_small, pos0 = self.edge_sample(key, (bg,), u2=u[:bg, 0:2])
        src = jnp.repeat(src_small, group)
        pos = self.target_sample(key, src, u2=u[:, 2:4])
        pos = pos.at[::group].set(pos0)
        if bg + n_negs <= batch:
            # rows bg.. of cols 0:2 are unused by the edge draw
            u_neg = u[bg : bg + n_negs, 0:2]
        else:
            u_neg = jax.random.uniform(
                jax.random.fold_in(key, 1), (n_negs, 2)
            )
        negs = self.negative_sample(key, (n_negs,), u2=u_neg)
        return src, pos, negs
