"""Shared scaffolding for walk-based SGNS models (DeepWalk family).

Reference loop shape (src/model/DeepWalk.cpp:98-155): per epoch, shuffle
all vertices, then per vertex: RandomWalk -> mapper -> UpdatePairs, with
alpha decayed linearly over walk_times * N walks.

Loop shape: one jitted step draws a batch of start vertices, runs the
whole walk + mapper + fused masked SGNS update on device; the alpha
schedule counts walks. Starts are drawn uniformly at random rather than
via a per-epoch permutation -- identical in expectation, and it keeps the
step free of host-fed state. (An epoch-exact permutation stream can be
threaded through ctx later if parity experiments need it.)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from smore_tpu.models.base import (
    PairModelBase,
    TrainDriver,
    freshness_policy,
    hoisted_scan_step,
    trunc_mass_multiplier,
    init_embedding,
    zeros_embedding,
)
from smore_tpu.ops.update import sgns_shared_negs_step


class WalkSGNSBase(PairModelBase):
    """Base for models whose step = (walks -> positive pairs -> SGNS)."""

    def init(self, dim: int) -> None:
        self.dim = dim
        n = self.graph.n_vertices
        k1, _ = jax.random.split(self._key())
        self.state = {
            "vertex": init_embedding(k1, n, dim),
            "context": zeros_embedding(n, dim),
        }
        self.build_sampler()

    # subclasses: build (src, ctx, mask) flat pair arrays from one batch
    def _emit_pairs(self, tables, key, starts):
        raise NotImplementedError

    def _make_ctx(self):
        """Pytree passed to the jitted step (tables by default)."""
        return self.build_sampler()

    def _tables_of(self, ctx):
        return ctx

    def _make_step(
        self, batch_walks: int, negatives: int, shared_negatives: int,
        collision: str, hoist: int = 1, epoch_starts: bool = False,
    ):
        def draw(ctx, key, n_walks, n_negs):
            tables = self._tables_of(ctx)
            k_s, k_w, k_n = jax.random.split(key, 3)
            n = tables.vertex_prob.shape[0]
            if epoch_starts:
                # Reference start law (DeepWalk.cpp:121-133): per epoch,
                # Fisher-Yates shuffle of ALL vertices, each starting
                # exactly one walk. One hoisted block = one epoch here;
                # any block slack beyond n is filled with uniform draws.
                perm = jax.random.permutation(k_s, n).astype(jnp.int32)
                if n_walks > n:
                    fill = jax.random.randint(
                        jax.random.fold_in(k_s, 1), (n_walks - n,), 0, n,
                        dtype=jnp.int32,
                    )
                    starts = jnp.concatenate([perm, fill])
                else:
                    starts = perm[:n_walks]
            else:
                starts = jax.random.randint(
                    k_s, (n_walks,), 0, n, dtype=jnp.int32
                )
            src, pos, mask = self._emit_pairs(ctx, k_w, starts)
            negs = tables.negative_sample(k_n, (n_negs,))
            return src, pos, mask, negs

        passes = int(getattr(self, "inner_passes", 1))

        def update(state, x, alpha):
            src, pos, mask, negs = x
            wv, wc = state["vertex"], state["context"]
            # inner_passes > 1: re-evaluate the gradients at the updated
            # tables on the SAME samples (alpha split across passes) --
            # approximates the reference's sequential per-pair updates
            # WITHIN a step. With the zero-init context table a single
            # batched pass gives every pair cp=0 at once (no positive
            # signal reaches the vertex side all step), while the
            # reference's in-walk sequencing bootstraps immediately;
            # this is the truncated-budget gap's mechanism.
            for _ in range(passes):
                wv, wc, loss = sgns_shared_negs_step(
                    wv, wc, src, pos, negs,
                    alpha / passes, k_equiv=negatives, mask=mask,
                    collision=collision,
                )
            return {"vertex": wv, "context": wc}, loss

        if hoist > 1:
            # Walk generation for ``hoist`` batches in ONE call (walks
            # are state-independent, so this is the same law-preserving
            # mega-draw as LINE's hoist, models/line.py); the mapper's
            # flat pair arrays are per-walk blocks in start order, so the
            # (hoist, batch*pairs_per_walk) reshape is exact.
            def hdraw(ctx, key):
                src, pos, mask, negs = draw(
                    ctx, key, hoist * batch_walks,
                    hoist * shared_negatives,
                )
                return (src.reshape(hoist, -1), pos.reshape(hoist, -1),
                        mask.reshape(hoist, -1),
                        negs.reshape(hoist, shared_negatives))

            return hoisted_scan_step(hdraw, update, hoist)

        def step(state, ctx, key, alpha):
            x = draw(ctx, key, batch_walks, shared_negatives)
            return update(state, x, alpha)

        return step

    def _run(
        self,
        total_walks: int,
        batch_walks: int,
        negatives: int,
        alpha: float,
        steps_per_call: int,
        shared_negatives: int,
        collision: str,
        verbose: bool,
        mesh=None,
        sharding: str = "dp",
        hoist: int = 1,
    ) -> None:
        n = self.graph.n_vertices
        epoch_starts = False
        if mesh is not None and sharding == "dp":
            hoist = 1  # DP merges per-device deltas every step
        else:
            # truncated-budget auto-policy: approximate the reference's
            # per-sample freshness when the walk budget is small
            # (base.freshness_policy; gated by walk_parity trunc runs)
            bw2, hoist = freshness_policy(total_walks, batch_walks, hoist)
            if bw2 != batch_walks:
                # The regime where batched steps lag the reference's
                # sequential per-pair updates. Root cause (measured,
                # experiments/trunc_walk_sweep.py + CPU pass sweep): with
                # the zero-init context table, one batched pass gives
                # every pair cp=0 simultaneously -- no positive signal
                # reaches the vertex side for a whole step -- while the
                # reference's in-walk sequencing bootstraps immediately.
                # Re-evaluating gradients over the same samples
                # (inner_passes=4, step mass alpha*2 split across
                # passes) recovers the sequential dynamics: deepwalk
                # walk_times=2 link-AUC 0.700 -> 0.950 vs the
                # reference's 0.940. Engages ONLY here; default budgets
                # are untouched (0.9966 parity stands).
                if getattr(self, "inner_passes", 0) in (0, 1):
                    self.inner_passes = 4
                    # Step mass across the passes: batch-aware x3/x2
                    # (see base.trunc_mass_multiplier for the measured
                    # calibration and the APP collapse it guards).
                    alpha = alpha * trunc_mass_multiplier(bw2)
            batch_walks = bw2
            # Epoch-exact start coverage (the reference's per-epoch
            # shuffle): one hoisted block = one epoch. Under iid starts
            # a walk_times=2 run leaves ~13% of vertices with no walk
            # (Poisson), which dominates the truncated-budget quality
            # gap (experiments/trunc_walk_sweep.py: batch/negative-pool
            # sizing moved link-AUC 0.705-0.712 while the reference sat
            # at 0.939). Gated to graphs where an epoch's mega-draw
            # fits comfortably in memory.
            steps_per_epoch = -(-n // batch_walks)
            if n <= 131_072 and steps_per_epoch <= 1024:
                epoch_starts = True
                hoist = steps_per_epoch
        driver = TrainDriver(
            self._make_step(
                batch_walks, negatives, shared_negatives, collision,
                hoist, epoch_starts,
            ),
            ctx=self._make_ctx(),
            samples_per_step=batch_walks * hoist,  # schedule counts WALKS
            alpha=alpha,
            total_samples=total_walks,
            steps_per_call=max(1, steps_per_call // hoist),
            micro_steps=hoist,
            mesh=mesh,
            sharding=sharding,
            **self._ckpt_kw(),
        )
        self.state = driver.train(self.state, self._key(), verbose=verbose)
