"""Band-stratified edge sampling: the large-table path.

Motivation: random-row scatter-adds into a small table are cheaper than
into a large one, and a step whose rows all lie in one band keeps its
working set small enough to stay in cache.

Design: partition the context-table row space into BANDS of `band_size`
rows. Each training step first draws a band b with probability equal to
the band's share of the edge-sample mass, then draws its whole batch of
(src, pos) pairs CONDITIONED on pos being in band b. The step's positive
scatter then touches only rows [b*band, (b+1)*band), so the XLA step
dynamic-slices that band out of the big table, scatters into it, and
writes the band back.

Law exactness: P(band) * P(src, pos | band) telescopes to the unbanded
joint edge law P_v(src) * w^0.75 / Z_src (SamplerTables.edge_pa law) --
the mixture over steps is EXACTLY the reference's two-stage sampling law
(proNet::SourceSample + TargetSample(vid), proNet.cpp:623-683). The same
holds per-pair under grouped draws: marginalizing the band out of
(extra context | src, band) recovers w^0.75 / Z_src. Stratification only
changes WHICH samples share a step (within-step correlation), as grouped
draws already do; quality is gated by the community-AUC parity runs.

Memory: the banded edge table stores both the slot edge and its alias
edge inline -- a (E, 8) f32 row (32 B) so ONE gather serves the whole
ungrouped draw; the (segment offset, length) pointers for grouped context
draws live in a separate (E, 4) table gathered only when group > 1.

Two flavors (build(two_d=...)):
  1D (two_d=False): strata = dst band only. The source side is handled
     by grouped draws (src gather/scatter shrink by the group factor).
     Used by LINE order-1, where source rows share the context table.
  2D (two_d=True, default): strata = (src band, dst band) pairs -- BOTH
     tables' scatters ride a band slice, so group=1 (the reference's
     exact per-sample source diversity) keeps full speed. At a 40M
     budget on the Youtube-scale graph, group=8 lagged the reference's
     convergence while banded group=1 matched it -- grouping, not
     banding, was the gap (a quality result of the earlier build).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from smore_tpu.graph.graph import Graph
from smore_tpu.sampling.alias import build_alias, build_alias_segmented
from smore_tpu.sampling.tables import SamplerTables, _vertex_distribution

# edge_pa column layout (slot edge | alias edge):
#   0 prob | 1 src 2 dst | 3 asrc 4 adst   (5..7 zero pad)
# Segment data for GROUPED draws lives in the separate edge_seg table
# ((E, 4): seg_off, seg_deg, aseg_off, aseg_deg) so the ungrouped
# production draw gathers 32-byte rows instead of 64.
_EDGE_COLS = 8

# Default band size: ~32k rows (8 MB of f32 x 64), a multiple of 8 and NOT
# divisible by a large power of two (32776 = 8 * 17 * 241), because
# banding pads the table to n_bands * band_size. The value was tuned on
# another accelerator and has not been re-measured on the H100.
DEFAULT_BAND_SIZE = 32776


@jax.tree_util.register_pytree_node_class
@dataclass
class BandedTables:
    """Device-resident band-stratified edge sampler.

    band_pa:   (n_bands, 2) f32 [prob, alias] -- band mass alias table
    band_meta: (n_bands, 2) i32 [slot offset, slot count]
    edge_pa:   (E, 8) f32, banded slot layout (see module docstring)
    edge_seg:  (E, 4) f32 [seg_off, seg_deg, aseg_off, aseg_deg] --
               (src, band)-segment pointers, gathered only by GROUPED
               draws (group > 1)
    ctx_pa:    (E, 4) f32 [prob, dst, alias_dst, 0] -- within-(src,band)
               segment context alias table, aligned with edge_pa slots
    neg_pa:    (N, 2) f32 -- the global negative table (shared with the
               base SamplerTables; the negative law is NOT banded)
    """

    band_pa: jnp.ndarray
    band_meta: jnp.ndarray
    edge_pa: jnp.ndarray
    edge_seg: jnp.ndarray
    ctx_pa: jnp.ndarray
    neg_pa: jnp.ndarray
    band_size: int
    n_rows_padded: int
    n_bands: int
    two_d: bool

    def tree_flatten(self):
        children = (self.band_pa, self.band_meta, self.edge_pa,
                    self.edge_seg, self.ctx_pa, self.neg_pa)
        return children, (self.band_size, self.n_rows_padded,
                          self.n_bands, self.two_d)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)

    # ------------------------------------------------------------------ #
    @staticmethod
    def build(
        g: Graph,
        band_size: int = DEFAULT_BAND_SIZE,
        vertex_method: str = "out_degrees",
        power: float = 0.75,
        base: SamplerTables | None = None,
        two_d: bool = True,
    ) -> "BandedTables":
        n, e = g.n_vertices, g.n_edges
        if e == 0 or e >= (1 << 24) or n >= (1 << 24):
            raise ValueError(
                "banded tables need 0 < edges < 2^24 and vertices < 2^24 "
                "(float32-exact vids); fall back to SamplerTables"
            )
        n_bands = -(-n // band_size)
        n_pad = n_bands * band_size

        src = np.repeat(np.arange(n, dtype=np.int64), np.diff(g.indptr))
        dst = np.asarray(g.indices, dtype=np.int64)
        w = np.asarray(g.weights, dtype=np.float64)
        # stratum of an edge: dst band (1D) or (src band, dst band) (2D)
        if two_d:
            strat_of = (src // band_size) * n_bands + dst // band_size
            n_strata = n_bands * n_bands
        else:
            strat_of = dst // band_size
            n_strata = n_bands

        # sort slots by (stratum, src): strata contiguous, (src, stratum)
        # segments contiguous within each stratum
        order = np.lexsort((src, strat_of))
        bsrc, bdst, bw = src[order], dst[order], w[order]
        bstrat = strat_of[order]

        # joint edge-sample mass per slot: P_v(src) * w^0.75 / Z_src
        # (identical law to SamplerTables.edge_pa, tables.py:167-183)
        vmass = _vertex_distribution(g, vertex_method).astype(np.float64)
        vmass = np.where(vmass > 0, vmass**power, 0.0)
        w_pow = np.where(bw > 0, bw**power, 0.0)
        z = np.zeros(n, dtype=np.float64)
        np.add.at(z, bsrc, w_pow)
        jw = (vmass[bsrc] / max(vmass.sum(), 1e-300)) * (
            w_pow / np.maximum(z[bsrc], 1e-300)
        )

        strat_off = np.searchsorted(bstrat, np.arange(n_strata))
        strat_cnt = np.diff(np.append(strat_off, e)).astype(np.int64)

        # stratum mass alias table
        mass = np.zeros(n_strata, dtype=np.float64)
        np.add.at(mass, bstrat, jw)
        bp, ba = build_alias(mass, power=1.0)
        ba = np.where(ba < 0, np.arange(n_strata), ba)

        # per-stratum edge alias tables (flat, local alias -> global slot)
        strat_indptr = np.append(strat_off, e).astype(np.int64)
        ep, ea_local = build_alias_segmented(jw, strat_indptr, power=1.0)
        slot = np.arange(e, dtype=np.int64)
        ea = np.where(ea_local >= 0, strat_off[bstrat] + ea_local, slot)

        # (src, stratum) segments: runs of equal src within a stratum
        change = np.empty(e, dtype=bool)
        change[0] = True
        change[1:] = (bsrc[1:] != bsrc[:-1]) | (bstrat[1:] != bstrat[:-1])
        seg_start_idx = np.flatnonzero(change)
        seg_id_of_slot = np.cumsum(change) - 1
        seg_off = seg_start_idx[seg_id_of_slot]
        seg_indptr = np.append(seg_start_idx, e).astype(np.int64)
        seg_deg = np.diff(seg_indptr)[seg_id_of_slot]

        # within-segment context alias (extra grouped draws)
        cp, ca_local = build_alias_segmented(bw, seg_indptr, power=power)
        ca = np.where(ca_local >= 0, seg_off + ca_local, slot)

        edge_pa = np.zeros((e, _EDGE_COLS), dtype=np.float32)
        edge_pa[:, 0] = ep
        edge_pa[:, 1] = bsrc
        edge_pa[:, 2] = bdst
        edge_pa[:, 3] = bsrc[ea]
        edge_pa[:, 4] = bdst[ea]
        edge_seg = np.zeros((e, 4), dtype=np.float32)
        edge_seg[:, 0] = seg_off
        edge_seg[:, 1] = seg_deg
        edge_seg[:, 2] = seg_off[ea]
        edge_seg[:, 3] = seg_deg[ea]

        ctx_pa = np.zeros((e, 4), dtype=np.float32)
        ctx_pa[:, 0] = cp
        ctx_pa[:, 1] = bdst
        ctx_pa[:, 2] = bdst[ca]

        if base is None:
            # only the negative law is needed -- don't build (or keep)
            # the full sampler's HBM tables at exactly the scales where
            # banding engages
            neg_pa = SamplerTables.build_negative_table(g)
        else:
            neg_pa = base.neg_pa
        return BandedTables(
            band_pa=jnp.asarray(np.stack([bp, ba], 1), jnp.float32),
            band_meta=jnp.asarray(np.stack([strat_off, strat_cnt], 1),
                                  jnp.int32),
            edge_pa=jnp.asarray(edge_pa),
            edge_seg=jnp.asarray(edge_seg),
            ctx_pa=jnp.asarray(ctx_pa),
            neg_pa=neg_pa,
            band_size=band_size,
            n_rows_padded=n_pad,
            n_bands=n_bands,
            two_d=two_d,
        )

    # ------------------------------------------------------------------ #
    def draw_banded_batch(
        self, key: jax.Array, batch: int, group: int, n_negs: int
    ):
        """One stratified step draw.

        Returns (src_band_start, dst_band_start, src, pos, negs):
          src_band_start: () i32, first row of the sources' band (always
               0 for 1D tables -- sources are then unconstrained)
          dst_band_start: () i32, first row of the contexts' band
          src: (batch,) i32 in repeat layout (group consecutive samples
               per source; group=1 for ungrouped)
          pos: (batch,) i32 GLOBAL vids, all within the dst band
          negs: (n_negs,) i32 global shared negatives (unbanded law)
        """
        bg = batch // group
        kb, ku, kn = jax.random.split(key, 3)

        # stratum draw (one alias draw over n_strata)
        ub = jax.random.uniform(kb, (2,))
        ns = self.band_pa.shape[0]
        i = jnp.minimum((ub[0] * ns).astype(jnp.int32), ns - 1)
        brow = self.band_pa[i]
        s = jnp.where(ub[1] < brow[0], i, brow[1].astype(jnp.int32))
        meta = self.band_meta[s]
        off, cnt = meta[0], meta[1]
        if self.two_d:
            src_band_start = (s // self.n_bands) * self.band_size
            dst_band_start = (s % self.n_bands) * self.band_size
        else:
            src_band_start = jnp.int32(0)
            dst_band_start = s * self.band_size

        u = jax.random.uniform(ku, (batch, 2 if group == 1 else 4))
        # slot edge draw within the band
        r = (u[:bg, 0] * cnt).astype(jnp.int32)
        slot = off + jnp.minimum(r, jnp.maximum(cnt - 1, 0))
        row = self.edge_pa.at[slot].get(mode="promise_in_bounds")
        take = (u[:bg, 1] < row[:, 0])[:, None]
        picked = jnp.where(take, row[:, 1:3], row[:, 3:5])
        src_small = picked[:, 0].astype(jnp.int32)
        pos0 = picked[:, 1].astype(jnp.int32)

        if group == 1:
            src, pos = src_small, pos0
        else:
            seg = self.edge_seg.at[slot].get(mode="promise_in_bounds")
            segp = jnp.where(take, seg[:, 0:2], seg[:, 2:4])
            seg_off = segp[:, 0].astype(jnp.int32)
            seg_deg = segp[:, 1].astype(jnp.int32)
            src = jnp.repeat(src_small, group)
            so = jnp.repeat(seg_off, group)
            sd = jnp.repeat(seg_deg, group)
            rr = (u[:, 2] * sd).astype(jnp.int32)
            cslot = so + jnp.minimum(rr, jnp.maximum(sd - 1, 0))
            crow = self.ctx_pa.at[cslot].get(mode="promise_in_bounds")
            pos = jnp.where(u[:, 3] < crow[:, 0], crow[:, 1], crow[:, 2])
            pos = pos.astype(jnp.int32).at[::group].set(pos0)

        # global shared negatives (law unchanged, tables.py:228-239)
        un = jax.random.uniform(kn, (n_negs, 2))
        n = self.neg_pa.shape[0]
        j = jnp.minimum((un[:, 0] * n).astype(jnp.int32), n - 1)
        nrow = self.neg_pa.at[j].get(mode="promise_in_bounds")
        negs = jnp.where(un[:, 1] < nrow[:, 0], j,
                         nrow[:, 1].astype(jnp.int32))
        return src_band_start, dst_band_start, src, pos, negs

    def draw_banded_batches_hoisted(
        self, key: jax.Array, batch: int, group: int, n_negs: int,
        steps: int,
    ):
        """``steps`` consecutive draw_banded_batch draws in ONE shot.

        Identical in law to ``steps`` independent per-step draws: the
        band alias, within-band slot, grouped-context, and negative
        draws are all state-independent, so hoisting them out of the
        update scan changes nothing about the sampling distribution
        (same transform as SamplerTables.draw_edge_batches_hoisted,
        tables.py); it amortizes the per-gather fixed costs.

        Returns (sb, db, src, pos, negs) shaped (steps,), (steps,),
        (steps, batch), (steps, batch), (steps, n_negs); row i is step
        i's draw, same layout as draw_banded_batch."""
        bg = batch // group
        kb, ku, kn = jax.random.split(key, 3)

        ub = jax.random.uniform(kb, (steps, 2))
        ns = self.band_pa.shape[0]
        i = jnp.minimum((ub[:, 0] * ns).astype(jnp.int32), ns - 1)
        brow = self.band_pa.at[i].get(mode="promise_in_bounds")
        s = jnp.where(ub[:, 1] < brow[:, 0], i,
                      brow[:, 1].astype(jnp.int32))
        meta = self.band_meta.at[s].get(mode="promise_in_bounds")
        off, cnt = meta[:, 0], meta[:, 1]
        if self.two_d:
            sb = (s // self.n_bands) * self.band_size
            db = (s % self.n_bands) * self.band_size
        else:
            sb = jnp.zeros((steps,), jnp.int32)
            db = s * self.band_size

        u = jax.random.uniform(
            ku, (steps, batch, 2 if group == 1 else 4)
        )
        r = (u[:, :bg, 0] * cnt[:, None].astype(jnp.float32)).astype(
            jnp.int32
        )
        slot = off[:, None] + jnp.minimum(
            r, jnp.maximum(cnt[:, None] - 1, 0)
        )
        row = self.edge_pa.at[slot.reshape(-1)].get(
            mode="promise_in_bounds"
        ).reshape(steps, bg, -1)
        take = (u[:, :bg, 1] < row[:, :, 0])[:, :, None]
        picked = jnp.where(take, row[:, :, 1:3], row[:, :, 3:5])
        src_small = picked[:, :, 0].astype(jnp.int32)
        pos0 = picked[:, :, 1].astype(jnp.int32)

        if group == 1:
            src, pos = src_small, pos0
        else:
            seg = self.edge_seg.at[slot.reshape(-1)].get(
                mode="promise_in_bounds"
            ).reshape(steps, bg, -1)
            segp = jnp.where(take, seg[:, :, 0:2], seg[:, :, 2:4])
            seg_off = segp[:, :, 0].astype(jnp.int32)
            seg_deg = segp[:, :, 1].astype(jnp.int32)
            src = jnp.repeat(src_small, group, axis=1)
            so = jnp.repeat(seg_off, group, axis=1)
            sd = jnp.repeat(seg_deg, group, axis=1)
            rr = (u[:, :, 2] * sd.astype(jnp.float32)).astype(jnp.int32)
            cslot = so + jnp.minimum(rr, jnp.maximum(sd - 1, 0))
            crow = self.ctx_pa.at[cslot.reshape(-1)].get(
                mode="promise_in_bounds"
            ).reshape(steps, batch, -1)
            pos = jnp.where(u[:, :, 3] < crow[:, :, 0], crow[:, :, 1],
                            crow[:, :, 2]).astype(jnp.int32)
            pos = pos.at[:, ::group].set(pos0)

        un = jax.random.uniform(kn, (steps, n_negs, 2))
        n = self.neg_pa.shape[0]
        j = jnp.minimum((un[:, :, 0] * n).astype(jnp.int32), n - 1)
        nrow = self.neg_pa.at[j.reshape(-1)].get(
            mode="promise_in_bounds"
        ).reshape(steps, n_negs, -1)
        negs = jnp.where(un[:, :, 1] < nrow[:, :, 0], j,
                         nrow[:, :, 1].astype(jnp.int32))
        return sb, db, src, pos, negs

    def draw_banded_block(
        self, key: jax.Array, batch: int, group: int, n_negs: int,
        steps: int,
    ):
        """Band-PERSISTENT block draw: ONE stratum for ``steps``
        consecutive micro-batches.

        Law: each sample's marginal is still P(stratum) * P(pair |
        stratum) = the exact unbanded joint edge law (the same
        telescoping argument as draw_banded_batch -- the stratum is
        drawn by its edge-sample mass). What changes vs per-step
        stratification is only WHICH samples share a stratum: steps *
        batch consecutive samples now do, so the per-stratum budget
        allocation over a run is a multinomial with total/(steps*batch)
        trials instead of total/batch -- a variance, not a bias. The
        update step amortizes the band slice/write-back over the whole
        block (the point of holding: band copy traffic drops by the hold
        factor).
        Quality is gated at the 40M community-AUC parity budget like
        every banded config.

        Returns (sb, db, src, pos, negs) shaped (), (), (steps, batch),
        (steps, batch), (steps, n_negs): scalar band starts shared by
        every micro-batch; row i is micro-step i's draw."""
        bg = batch // group
        kb, ku, kn = jax.random.split(key, 3)

        ub = jax.random.uniform(kb, (2,))
        ns = self.band_pa.shape[0]
        i = jnp.minimum((ub[0] * ns).astype(jnp.int32), ns - 1)
        brow = self.band_pa[i]
        s = jnp.where(ub[1] < brow[0], i, brow[1].astype(jnp.int32))
        meta = self.band_meta[s]
        off, cnt = meta[0], meta[1]
        if self.two_d:
            sb = (s // self.n_bands) * self.band_size
            db = (s % self.n_bands) * self.band_size
        else:
            sb = jnp.int32(0)
            db = s * self.band_size

        u = jax.random.uniform(
            ku, (steps, batch, 2 if group == 1 else 4)
        )
        r = (u[:, :bg, 0] * cnt.astype(jnp.float32)).astype(jnp.int32)
        slot = off + jnp.minimum(r, jnp.maximum(cnt - 1, 0))
        row = self.edge_pa.at[slot.reshape(-1)].get(
            mode="promise_in_bounds"
        ).reshape(steps, bg, -1)
        take = (u[:, :bg, 1] < row[:, :, 0])[:, :, None]
        picked = jnp.where(take, row[:, :, 1:3], row[:, :, 3:5])
        src = picked[:, :, 0].astype(jnp.int32)
        pos0 = picked[:, :, 1].astype(jnp.int32)

        if group == 1:
            pos = pos0
        else:
            seg = self.edge_seg.at[slot.reshape(-1)].get(
                mode="promise_in_bounds"
            ).reshape(steps, bg, -1)
            segp = jnp.where(take, seg[:, :, 0:2], seg[:, :, 2:4])
            seg_off = segp[:, :, 0].astype(jnp.int32)
            seg_deg = segp[:, :, 1].astype(jnp.int32)
            src = jnp.repeat(src, group, axis=1)
            so = jnp.repeat(seg_off, group, axis=1)
            sd = jnp.repeat(seg_deg, group, axis=1)
            rr = (u[:, :, 2] * sd.astype(jnp.float32)).astype(jnp.int32)
            cslot = so + jnp.minimum(rr, jnp.maximum(sd - 1, 0))
            crow = self.ctx_pa.at[cslot.reshape(-1)].get(
                mode="promise_in_bounds"
            ).reshape(steps, batch, -1)
            pos = jnp.where(u[:, :, 3] < crow[:, :, 0], crow[:, :, 1],
                            crow[:, :, 2]).astype(jnp.int32)
            pos = pos.at[:, ::group].set(pos0)

        un = jax.random.uniform(kn, (steps, n_negs, 2))
        n = self.neg_pa.shape[0]
        j = jnp.minimum((un[:, :, 0] * n).astype(jnp.int32), n - 1)
        nrow = self.neg_pa.at[j.reshape(-1)].get(
            mode="promise_in_bounds"
        ).reshape(steps, n_negs, -1)
        negs = jnp.where(un[:, :, 1] < nrow[:, :, 0], j,
                         nrow[:, :, 1].astype(jnp.int32))
        return sb, db, src, pos, negs
