"""LINE (Large-scale Information Network Embedding), orders 1 and 2.

Reference: /root/reference/src/model/LINE.{h,cpp} and the Go port
/root/reference/internal/models/line/line.go.

Semantics preserved:
  - order=1: one shared table, both endpoints of a sampled edge updated
    (LINE.cpp:128-158 order-1 branch); init uniform(-0.5,0.5)/dim.
  - order=2: vertex table uniform-init, context table ZERO-init
    (LINE.cpp:92); SGNS with source drawn by out-degree^0.75 alias,
    context by per-vertex edge-weight alias, negatives by degree^0.75.
  - sample budget = sample_times * 1e6 edge samples; linear alpha decay
    to alpha*1e-4 (LINE.cpp:119-121,176-187).

Design: source/context/negative draws and the fused SGNS update all
run inside one jitted lax.scan (see smore_tpu/ops/update.py); the tables
are donated across calls so training is entirely on-device.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from smore_tpu.graph.graph import Graph
from smore_tpu.models.base import (
    PairModelBase,
    TrainDriver,
    clamp_batch,
    hoisted_scan_step,
    init_embedding,
    zeros_embedding,
)
from smore_tpu.ops.update import (
    sgns_banded_block,
    sgns_shared_negs_step,
    sgns_shared_negs_step_banded,
    sgns_step,
    sgns_step_shared,
)

# Banded stratified updates (sampling/banded.py) engage automatically on
# tables of at least this many rows. The value was tuned on another
# accelerator and has not been re-measured on the H100.
BANDED_AUTO_THRESHOLD = 262_144


class LINE(PairModelBase):
    def __init__(self, graph: Graph, seed: int = 0):
        super().__init__(graph, seed)
        self.order = 2

    def init(self, dim: int, order: int = 2) -> None:
        self.dim = dim
        self.order = order
        n = self.graph.n_vertices
        k1, _ = jax.random.split(self._key())
        if order == 1:
            self.state = {"vertex": init_embedding(k1, n, dim)}
        else:
            self.state = {
                "vertex": init_embedding(k1, n, dim),
                "context": zeros_embedding(n, dim),
            }
        # sampler tables build lazily in train(): the banded large-table
        # path needs only the negative law, so eager building here would
        # pin the full sampler in HBM at exactly the scales where the
        # banded path replaces it

    def _make_step(
        self,
        batch: int,
        negatives: int,
        collision: str = "sum",
        shared_negatives: int = 128,
        group: int = 1,
        hoist: int = 1,
    ):
        """shared_negatives > 0 (default): draw one pool of that many
        negatives per step and run the shared-pool fast path (see
        ops.update.sgns_shared_negs_step); 0 = strict per-sample negatives
        like the reference.

        group > 1: each drawn source contributes ``group`` consecutive
        context samples (walk-style source reuse; same conditional context
        law and source marginal, verified at AUC parity on the bench
        graph) -- shrinks the source-side draw/gather/scatter by the group
        factor.

        hoist > 1: draws for that many consecutive update batches run as
        ONE mega-draw before an inner scan (identical sampling law --
        draws are state-independent; SamplerTables.draw_edge_batches_
        hoisted), amortizing per-row gather costs. ``alpha`` then
        arrives as a (hoist,) vector from TrainDriver(micro_steps=hoist).
        Requires shared_negatives, group > 1 and the joint edge table."""
        order = self.order

        if shared_negatives and hoist > 1:
            Ks = shared_negatives
            kw = dict(
                k_equiv=negatives, collision=collision, src_group=group,
            )

            def update(st, x, a):
                src, pos, negs = x
                if order == 1:
                    w, _, loss = sgns_shared_negs_step(
                        st["vertex"], st["vertex"], src, pos, negs,
                        a, shared_table=True, **kw,
                    )
                    return {"vertex": w}, loss
                wv, wc, loss = sgns_shared_negs_step(
                    st["vertex"], st["context"], src, pos, negs, a, **kw,
                )
                return {"vertex": wv, "context": wc}, loss

            return hoisted_scan_step(
                lambda tables, key: tables.draw_edge_batches_hoisted(
                    key, batch, group, Ks, hoist
                ),
                update, hoist,
            )

        if shared_negatives:
            Ks = shared_negatives

            def step(state, tables, key, alpha):
                grouped = group > 1 and tables.has_edge_table
                if grouped:
                    src, pos, negs = tables.draw_edge_batch_grouped(
                        key, batch, group, Ks
                    )
                else:
                    src, pos, negs = tables.draw_edge_batch(key, batch, Ks)
                kw = dict(
                    k_equiv=negatives, collision=collision,
                    src_group=group if grouped else 1,
                )
                if order == 1:
                    w, _, loss = sgns_shared_negs_step(
                        state["vertex"], state["vertex"], src, pos, negs,
                        alpha, shared_table=True, **kw,
                    )
                    return {"vertex": w}, loss
                wv, wc, loss = sgns_shared_negs_step(
                    state["vertex"], state["context"], src, pos, negs,
                    alpha, **kw,
                )
                return {"vertex": wv, "context": wc}, loss

            return step

        def step(state, tables, key, alpha):
            k1, k2, k3 = jax.random.split(key, 3)
            src = tables.source_sample(k1, (batch,))
            pos = tables.target_sample(k2, src)
            negs = tables.negative_sample(k3, (batch, negatives))
            if order == 1:
                w, loss = sgns_step_shared(
                    state["vertex"], src, pos, negs, alpha, collision=collision
                )
                return {"vertex": w}, loss
            wv, wc, loss = sgns_step(
                state["vertex"], state["context"], src, pos, negs, alpha,
                collision=collision,
            )
            return {"vertex": wv, "context": wc}, loss

        return step

    def _make_banded_step(self, batch, negatives, shared_negatives, group,
                          hoist=1):
        order = self.order
        Ks = shared_negatives
        band_size = self.banded_tables.band_size

        two_d = self.banded_tables.two_d

        def inner(state, x, alpha):
            sb, db, src, pos, negs = x
            kw = dict(k_equiv=negatives, src_group=group)
            if order == 1:
                w, _, loss = sgns_shared_negs_step_banded(
                    state["vertex"], state["vertex"], db, band_size,
                    src, pos, negs, alpha, shared_table=True, **kw,
                )
                return {"vertex": w}, loss
            wv, wc, loss = sgns_shared_negs_step_banded(
                state["vertex"], state["context"], db, band_size,
                src, pos, negs, alpha,
                src_band_start=sb if two_d else None, **kw,
            )
            return {"vertex": wv, "context": wc}, loss

        if hoist > 1:
            return hoisted_scan_step(
                lambda bt, key: bt.draw_banded_batches_hoisted(
                    key, batch, group, Ks, hoist
                ),
                inner, hoist,
            )

        def step(state, bt, key, alpha):
            x = bt.draw_banded_batch(key, batch, group, Ks)
            return inner(state, x, alpha)

        return step

    def _make_banded_block_step(self, batch, negatives, shared_negatives,
                                group, hold):
        """Band-PERSISTENT superstep (order-2 only): one stratum held for
        ``hold`` micro-batches; both band slices are paid once per block
        instead of once per micro-step (ops.update.sgns_banded_block,
        sampling law unchanged -- BandedTables.draw_banded_block)."""
        band_size = self.banded_tables.band_size
        Ks = shared_negatives

        def step(state, bt, key, alphas):
            sb, db, src, pos, negs = bt.draw_banded_block(
                key, batch, group, Ks, hold
            )
            wv, wc, loss = sgns_banded_block(
                state["vertex"], state["context"], sb, db, band_size,
                src, pos, negs, alphas, k_equiv=negatives,
                src_group=group,
            )
            return {"vertex": wv, "context": wc}, loss

        return step

    def train(
        self,
        sample_times: int = 10,
        negative_samples: int = 5,
        alpha: float = 0.025,
        batch: int = 0,  # 0 = auto: 32768 (clamped to the table size).
        # An explicit value is always respected as-is.
        steps_per_call: int = 128,
        collision: str = "sum",
        shared_negatives: int = 128,
        group: int = 0,  # 0 = auto: 1 on the banded order-2 path (2D
        # strata make grouped source reuse unnecessary, and group=1 is
        # the reference's exact per-sample source law), 8 everywhere else
        hoist: int = 0,  # 0 = auto: mega-draw for N batches at a time
        # (identical law -- draws are state-independent). 32 on the
        # grouped shared-negatives path for single-device AND rows
        # sharding (same logical single-stream program, so rows stays
        # bit-identical to single-device); 8 on the banded path; 1 under
        # mesh DP (per-device deltas merge each step, so hoisting would
        # change the merge cadence)
        banded: object = "auto",  # True | False | "auto" (see module
        # constant): band-stratified updates, the large-table path
        band_hold: object = "auto",  # band-PERSISTENT superstep (order-2
        # banded path): hold ONE stratum for the whole hoist block so
        # both band slices are paid once per block instead of once per
        # micro-step (sgns_banded_block; per-SAMPLE law unchanged, but
        # steps*batch consecutive samples share a stratum, which costs
        # quality at the 40M gate) -- so "auto" = OFF
        band_size: int = 0,  # 0 = sampling.banded.DEFAULT_BAND_SIZE
        mesh=None,
        sharding: str = "dp",
        verbose: bool = True,
    ) -> None:
        total = int(sample_times * 1_000_000)
        n = self.graph.n_vertices
        if batch == 0:
            batch = 32768
        # Multi-device: the banded path runs under a mesh via the
        # driver's "hogwild" mode (per-device independent full-law
        # streams on replicated tables, delta-psum merge once per jit
        # call -- the analog of the reference's hogwild threads,
        # LINE.cpp:162; see TrainDriver.__init__). Explicit
        # sharding="rows" (the bigger-than-one-card capacity mode) keeps
        # the unbanded GSPMD row-sharded path.
        use_banded = bool(
            shared_negatives
            and collision == "sum"
            and (mesh is None or sharding in ("dp", "hogwild"))
            and 0 < self.graph.n_edges < (1 << 24)
            and n < (1 << 24)
            and (banded is True
                 or (banded == "auto" and n >= BANDED_AUTO_THRESHOLD))
        )
        if use_banded and mesh is not None:
            sharding = "hogwild"
        if group == 0:
            group = 1 if (use_banded and self.order == 2) else 8
        if group > 1 and batch % group:
            raise ValueError(f"batch {batch} not divisible by group {group}")
        batch = clamp_batch(self.graph.n_vertices, batch, group=group)
        if shared_negatives:
            shared_negatives = min(shared_negatives, batch)
        if (
            hoist != 1
            and not use_banded
            and not self.build_sampler().has_edge_table
        ):
            # the hoisted step REQUIRES the joint edge table; on
            # degenerate tables (>=2^24 edges/vertices) fall back to the
            # per-step path, which has its own two-stage fallback
            hoist = 1
        if hoist == 0:
            if use_banded and shared_negatives:
                hoist = 8
            elif (
                shared_negatives
                and group > 1
                and (mesh is None or sharding == "rows")
                and self.build_sampler().has_edge_table
            ):
                hoist = 32
            else:
                hoist = 1

        if use_banded:
            from smore_tpu.sampling.banded import (
                DEFAULT_BAND_SIZE,
                BandedTables,
            )

            band_size = band_size or DEFAULT_BAND_SIZE
            two_d = self.order == 2
            bt = getattr(self, "banded_tables", None)
            if bt is None or bt.band_size != band_size or bt.two_d != two_d:
                bt = BandedTables.build(
                    self.graph, band_size=band_size, two_d=two_d,
                    vertex_method=self.vertex_method, base=self.tables,
                )
                self.banded_tables = bt
            n_pad = bt.n_rows_padded
            state = {
                k: jnp.pad(v, ((0, n_pad - n), (0, 0)))
                for k, v in self.state.items()
            }
            use_hold = band_hold is True and self.order == 2 and hoist > 1
            if use_hold:
                step_fn = self._make_banded_block_step(
                    batch, negative_samples, shared_negatives, group,
                    hoist,
                )
            else:
                step_fn = self._make_banded_step(
                    batch, negative_samples, shared_negatives, group,
                    hoist,
                )
            self.step_name = "banded, held band" if use_hold else "banded"
            if verbose:
                print(f"\tstep: {self.step_name}, batch {batch}, "
                      f"hoist {hoist}, band {band_size}", flush=True)
            self.last_driver = driver = TrainDriver(
                step_fn,
                ctx=bt,
                samples_per_step=batch * hoist,
                alpha=alpha,
                total_samples=total,
                steps_per_call=max(1, steps_per_call // hoist),
                micro_steps=hoist,
                mesh=mesh,
                sharding=sharding,
                **self._ckpt_kw(),
            )
            out = driver.train(state, self._key(), verbose=verbose)
            self.state = {k: v[:n] for k, v in out.items()}
            return

        self.step_name = "unbanded"
        if verbose:
            print(f"\tstep: {self.step_name}, batch {batch}, "
                  f"hoist {hoist}, group {group}", flush=True)
        self.last_driver = driver = TrainDriver(
            self._make_step(batch, negative_samples, collision,
                            shared_negatives, group, hoist),
            ctx=self.build_sampler(),
            samples_per_step=batch * hoist,
            alpha=alpha,
            total_samples=total,
            steps_per_call=max(1, steps_per_call // hoist),
            mesh=mesh,
            sharding=sharding,
            micro_steps=hoist,
            **self._ckpt_kw(),
        )
        self.state = driver.train(self.state, self._key(), verbose=verbose)

    def save_weights(self, path: str, table: str = "vertex") -> None:
        super().save_weights(path, table="vertex")
