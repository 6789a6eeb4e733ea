"""HPE (heterogeneous preference embedding) and PE (proximity embedding).

Reference:
  - HPE: /root/reference/src/model/HPE.cpp (Train :94-148): per sampled
    edge (v1, v2), UpdateCommunity walks walk_steps contexts starting AT
    v2 (proNet.cpp:3018-3054; each context gets SGNS-with-L2 against v1,
    dead end breaks the walk), plus one reversed UpdatePair(v2, v1).
  - PE: /root/reference/src/model/ProximityEmbedding.cpp (Train :59-113):
    just the reversed pair UpdatePair(v2, v1); the per-vertex walk meta
    ("-walk_meta" file) is loaded but the community branch is commented
    out in the reference.
CLI defaults (cli/hpe.cpp): dim=64, sample_times=10, walk_steps=5,
neg=5, reg=0.01, alpha=0.025.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from smore_tpu.models.base import (
    clamp_batch,
    hoisted_scan_step,
    PairModelBase,
    TrainDriver,
    init_embedding,
    zeros_embedding,
)
from smore_tpu.ops.update import sgns_shared_negs_step
from smore_tpu.sampling.walks import random_walk


def community_walk_pairs(tables, key, src, pos, walk_steps: int):
    """UpdateCommunity's context set: pos itself plus walk_steps-1 walk
    extensions, masked past the first dead end. Returns flat (vertex (M,),
    context (M,), mask (M,)) with M = B * walk_steps."""
    B = src.shape[0]
    if walk_steps <= 1:
        return src, pos, jnp.ones((B,), dtype=jnp.float32)
    walk, _ = random_walk(
        tables, key, pos, walk_steps - 1, restart_on_deadend=False
    )  # (B, walk_steps); cursor freezes on dead ends
    deg = tables.vert_meta.at[walk].get(mode="promise_in_bounds")[..., 1]
    # position t is valid iff every earlier position had out-edges
    alive = jnp.cumprod(
        jnp.concatenate(
            [jnp.ones((B, 1), jnp.float32), (deg[:, :-1] > 0).astype(jnp.float32)],
            axis=1,
        ),
        axis=1,
    )
    vtx = jnp.broadcast_to(src[:, None], walk.shape)
    return vtx.reshape(-1), walk.reshape(-1), alive.reshape(-1)


def build_walk_bank(tables, key, n_vertices: int, k: int,
                    walk_steps: int) -> jnp.ndarray:
    """Pre-draw k community-walk extensions per START vertex, ONCE.

    HPE's per-sample cost is dominated by the walk generation's
    walk_steps-1 sequential dependent target-draws (batch-insensitive on
    the earlier build). Walks depend only on the
    graph, so they can be drawn up front (one batched device call) and
    REUSED: a training sample then fetches one pre-drawn (walk_steps-1,)
    extension row with a single gather. Per-walk law is exact (each bank
    entry is an iid draw of proNet::RandomWalk's law from that start);
    the deviation is bootstrap reuse among k walks per start vertex,
    gated by the bpr_parity/longtail HPE quality rows.

    Returns (N, k, walk_steps-1) int32 with bit 30 set on INVALID
    positions (past the first dead end)."""
    S = walk_steps - 1
    starts = jnp.repeat(jnp.arange(n_vertices, dtype=jnp.int32), k)
    walk, _ = random_walk(
        tables, key, starts, S, restart_on_deadend=False
    )  # (N*k, S+1) incl. the start column
    deg = tables.vert_meta.at[walk].get(mode="promise_in_bounds")[..., 1]
    valid = jnp.cumprod((deg[:, :-1] > 0).astype(jnp.int32), axis=1)
    entries = walk[:, 1:] | ((1 - valid) << 30)
    return entries.reshape(n_vertices, k, S)


def community_walk_pairs_bank(bank, key, src, pos, walk_steps: int):
    """community_walk_pairs drawing the walk extension from a pre-drawn
    bank (build_walk_bank): one (walk_steps-1,)-row gather per sample
    instead of walk_steps-1 dependent alias-draw rounds."""
    B = src.shape[0]
    if walk_steps <= 1:
        return src, pos, jnp.ones((B,), dtype=jnp.float32)
    k = bank.shape[1]
    r = jax.random.randint(key, (B,), 0, k)
    rows = bank[pos, r]  # (B, S-1)
    vids = rows & ((1 << 30) - 1)
    valid = 1 - (rows >> 30)
    walk = jnp.concatenate([pos[:, None], vids], axis=1)
    alive = jnp.concatenate(
        [jnp.ones((B, 1), jnp.float32), valid.astype(jnp.float32)],
        axis=1,
    )
    vtx = jnp.broadcast_to(src[:, None], walk.shape)
    return vtx.reshape(-1), walk.reshape(-1), alive.reshape(-1)


class HPE(PairModelBase):
    def __init__(self, graph, seed: int = 0):
        super().__init__(graph, seed)
        self.walk_steps = 5
        self.reg = 0.01

    def init(self, dim: int) -> None:
        self.dim = dim
        n = self.graph.n_vertices
        k1, _ = jax.random.split(self._key())
        self.state = {
            "vertex": init_embedding(k1, n, dim),
            "context": zeros_embedding(n, dim),
        }
        self.build_sampler()

    def _make_step(self, batch, negatives, shared_negatives, collision,
                   hoist=1, use_bank=False):
        S = self.walk_steps
        reg = self.reg

        def draw(ctx, key, n, n_negs):
            # ctx = (tables, walk bank | None); the bank is a device
            # array and must arrive via ctx, not closure (closures bake
            # arrays into the executable -- verify-skill gotcha)
            tables, bank = ctx
            k1, k2, k3, k4 = jax.random.split(key, 4)
            if tables.has_edge_table:
                src, pos = tables.edge_sample(k1, (n,))
            else:
                src = tables.source_sample(k1, (n,))
                pos = tables.target_sample(k2, src)
            negs = tables.negative_sample(k3, (n_negs,))
            if use_bank:
                cv, cc, cmask = community_walk_pairs_bank(
                    bank, k4, src, pos, S
                )
            else:
                cv, cc, cmask = community_walk_pairs(
                    tables, k4, src, pos, S
                )
            return src, pos, negs, cv, cc, cmask

        def update(state, x, alpha):
            src, pos, negs, cv, cc, cmask = x
            wv, wc = state["vertex"], state["context"]
            # community: v1 vs walk-extended contexts of v2, with L2.
            # cv is repeat-layout (each v1 repeated S times), so the
            # vertex-side gather/scatter shrinks by src_group=S.
            wv, wc, l1 = sgns_shared_negs_step(
                wv, wc, cv, cc, negs, alpha, k_equiv=negatives,
                mask=cmask, reg=reg, collision=collision,
                src_group=S if S > 1 else 1,
            )
            # reversed plain pair (v2 -> v1), no L2 (UpdatePair)
            wv, wc, l2 = sgns_shared_negs_step(
                wv, wc, pos, src, negs, alpha, k_equiv=negatives,
                collision=collision,
            )
            return {"vertex": wv, "context": wc}, l1 + l2

        if hoist > 1:
            # mega-draw (edges + community walks + negatives are all
            # state-independent; same law-preserving transform as LINE's
            # hoist). community_walk_pairs flattens per-sample blocks in
            # draw order, so the (hoist, batch*S) reshape is exact.
            def hdraw(tables, key):
                src, pos, negs, cv, cc, cmask = draw(
                    tables, key, hoist * batch, hoist * shared_negatives
                )
                return (src.reshape(hoist, batch),
                        pos.reshape(hoist, batch),
                        negs.reshape(hoist, shared_negatives),
                        cv.reshape(hoist, -1), cc.reshape(hoist, -1),
                        cmask.reshape(hoist, -1))

            return hoisted_scan_step(hdraw, update, hoist)

        def step(state, tables, key, alpha):
            return update(state, draw(tables, key, batch,
                                      shared_negatives), alpha)

        return step

    def train(
        self,
        sample_times: int = 10,
        walk_steps: int = 5,
        negative_samples: int = 5,
        reg: float = 0.01,
        alpha: float = 0.025,
        batch: int = 8192,
        steps_per_call: int = 64,
        shared_negatives: int = 256,
        collision: str = "sum",
        hoist: int = 0,  # mega-draw for N batches (identical law; see
        # models/line.py). 0 = auto: 8 single-stream (draw amortization,
        # experiments/hoist_breadth.py), 1 otherwise.
        walk_bank: int = 16,  # pre-draw this many community-walk
        # extensions per start vertex ONCE (build_walk_bank) and reuse
        # them -- removes the walk_steps-1 sequential dependent
        # alias-draw rounds that bound HPE's throughput. Per-walk law
        # exact; reuse gated by the
        # bpr_parity HPE quality row. 0 = fresh walks every step.
        verbose: bool = True,
    ) -> None:
        self.walk_steps = walk_steps
        self.reg = reg
        if hoist == 0:
            hoist = 8
        batch = clamp_batch(self.graph.n_vertices, batch)
        tables = self.build_sampler()
        bank = None
        if walk_bank > 0 and walk_steps > 1:
            bank = build_walk_bank(
                tables, jax.random.fold_in(self._key(), 77),
                self.graph.n_vertices, walk_bank, walk_steps,
            )
        driver = TrainDriver(
            self._make_step(batch, negative_samples, shared_negatives,
                            collision, hoist, use_bank=bank is not None),
            ctx=(tables, bank),
            samples_per_step=batch * hoist,
            alpha=alpha,
            total_samples=int(sample_times * 1_000_000),
            steps_per_call=max(1, steps_per_call // hoist),
            micro_steps=hoist,
            **self._ckpt_kw(),
        )
        self.state = driver.train(self.state, self._key(), verbose=verbose)


class PE(PairModelBase):
    """Proximity embedding: reversed-pair SGNS (PE::Train's live branch).

    Per-vertex dynamic walk meta: the reference exposes PE::LoadWalkMeta
    (ProximityEmbedding.cpp:6-7 -> proNet::LoadWalkMeta, proNet.cpp:
    288-328) but its consumer, the UpdateDCommunity call, is commented
    out (ProximityEmbedding.cpp:105-106) -- the meta is dead code there.
    Here ``load_walk_meta`` wires the documented intent through: each
    sampled (v1, v2) contributes reversed pairs against v2 plus walk
    extensions of v2, masked at v1's per-vertex step count. With every
    vertex at steps=1 this reduces EXACTLY to the live reference branch
    (only v2 itself)."""

    def __init__(self, graph, seed: int = 0):
        super().__init__(graph, seed)

    def init(self, dim: int) -> None:
        self.dim = dim
        n = self.graph.n_vertices
        k1, _ = jax.random.split(self._key())
        self.state = {
            "vertex": init_embedding(k1, n, dim),
            "context": zeros_embedding(n, dim),
        }
        self.build_sampler()

    def load_walk_meta(self, path: str) -> None:
        """Reference PE::LoadWalkMeta: ``vertex steps`` file, default 3."""
        self.graph.load_walk_meta(path)

    def _dynamic_steps(self):
        return getattr(self.graph, "walk_steps", None)

    def _make_step(self, batch, negatives, shared_negatives, collision):
        dyn = self._dynamic_steps()
        if dyn is None:
            def step(state, ctx, key, alpha):
                tables, _ = ctx
                k1, k2, k3 = jax.random.split(key, 3)
                src = tables.source_sample(k1, (batch,))
                pos = tables.target_sample(k2, src)
                negs = tables.negative_sample(k3, (shared_negatives,))
                wv, wc, loss = sgns_shared_negs_step(
                    state["vertex"], state["context"], pos, src, negs,
                    alpha, k_equiv=negatives, collision=collision,
                )
                return {"vertex": wv, "context": wc}, loss

            return step

        S = int(max(1, min(int(np.max(dyn)), 32)))  # static walk buffer

        def step(state, ctx, key, alpha):
            tables, dyn_steps = ctx
            k1, k2, k3, k4 = jax.random.split(key, 4)
            src = tables.source_sample(k1, (batch,))
            pos = tables.target_sample(k2, src)
            negs = tables.negative_sample(k3, (shared_negatives,))
            cv, cc, alive = community_walk_pairs(tables, k4, src, pos, S)
            # context position t (0 = v2 itself) valid while t < steps[v1]
            t = jnp.broadcast_to(
                jnp.arange(S, dtype=jnp.int32)[None, :], (batch, S)
            ).reshape(-1)
            dsteps = dyn_steps.at[cv].get(mode="promise_in_bounds")
            mask = alive * (t < dsteps).astype(jnp.float32)
            wv, wc, loss = sgns_shared_negs_step(
                state["vertex"], state["context"], cc, cv, negs, alpha,
                k_equiv=negatives, mask=mask, collision=collision,
            )
            return {"vertex": wv, "context": wc}, loss

        return step

    def train(
        self,
        sample_times: int = 10,
        negative_samples: int = 5,
        alpha: float = 0.025,
        batch: int = 8192,
        steps_per_call: int = 128,
        shared_negatives: int = 128,
        collision: str = "sum",
        verbose: bool = True,
    ) -> None:
        batch = clamp_batch(self.graph.n_vertices, batch)
        dyn = self._dynamic_steps()
        ctx = (
            self.build_sampler(),
            jnp.zeros((0,), jnp.int32) if dyn is None
            else jnp.asarray(dyn, jnp.int32),
        )
        driver = TrainDriver(
            self._make_step(batch, negative_samples, shared_negatives, collision),
            ctx=ctx,
            samples_per_step=batch,
            alpha=alpha,
            total_samples=int(sample_times * 1_000_000),
            steps_per_call=steps_per_call,
            **self._ckpt_kw(),
        )
        self.state = driver.train(self.state, self._key(), verbose=verbose)
