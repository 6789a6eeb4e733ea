"""HOP-REC: high-order proximity chains with decayed ranking updates.

Reference: /root/reference/src/model/HBPR.cpp (the ``hoprec`` CLI,
cli/hoprec.cpp) -- Train (HBPR.cpp:63-131):
  - sources restricted to field 0 (users), resampled until match
  - hop chain: cid_1 = TargetSample(vid); for w>1, cid_w = two more
    TargetSample hops from cid_{w-1} (stays on the item side of the
    bipartite graph)
  - negative per hop: resampled until field(nid) == field(cid_w)
  - UpdateFBPRPair(vid, cid_w, nid, alpha/w, margin/w) on ONE table,
    margin-filtered BPR (skip when score diff > margin/w)

Batched form: the chain is a fixed (B, walk_steps) walk (2 hops per level),
field-matched negatives come from per-field alias tables
(smore_tpu/sampling/fields.py), and all levels update in one fbpr_step
with per-pair alpha/margin vectors. CLI defaults: dim=64 (typically 128
for HOP-REC), sample_times=10, walk_steps=5, alpha=0.025, margin=1.0.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from smore_tpu.models.base import (
    clamp_batch,
    PairModelBase,
    TrainDriver,
    init_embedding,
)
from smore_tpu.ops.update import fbpr_step
from smore_tpu.sampling.fields import FieldTables


class HOPREC(PairModelBase):
    negative_method = "no_degrees"

    def __init__(self, graph, seed: int = 0):
        super().__init__(graph, seed)
        self.walk_steps = 5
        self.margin = 1.0

    def init(self, dim: int) -> None:
        self.dim = dim
        k1, _ = jax.random.split(self._key())
        self.state = {"vertex": init_embedding(k1, self.graph.n_vertices, dim)}
        self.build_sampler()

    def _make_ctx(self):
        g = self.graph
        # source table restricted to field 0, mass = out_degree (the
        # reference's SourceSample + reject-until-field-0 loop)
        src_tables = FieldTables.build(g, weights=g.out_degree)
        # negatives: "no_degrees" uniform over vertices with in-edges,
        # field-matched (HBPR.cpp:111-113)
        neg_tables = FieldTables.build(
            g, weights=(g.in_degree > 0).astype(np.float64)
        )
        return (self.build_sampler(), src_tables, neg_tables)

    def _make_step(self, batch, collision):
        W = self.walk_steps
        margin = self.margin

        def step(state, ctx, key, alpha):
            tables, src_t, neg_t = ctx
            k1, k2, k3 = jax.random.split(key, 3)
            zeros = jnp.zeros((batch,), dtype=jnp.int32)
            vid = src_t.negative_field_sample(k1, zeros)  # field-0 users

            # hop chain: cid_1 = 1 hop; cid_w = cid_{w-1} + 2 hops
            u = jax.random.uniform(k2, (batch, 2 * W - 1, 2))
            cur = tables.target_sample(None, vid, u2=u[:, 0])
            cids = [cur]
            for h in range(1, W):
                cur = tables.target_sample(None, cur, u2=u[:, 2 * h - 1])
                cur = tables.target_sample(None, cur, u2=u[:, 2 * h])
                cids.append(cur)
            cid = jnp.stack(cids, axis=1)  # (B, W)

            # field-matched negatives per hop
            nid = neg_t.negative_field_sample(
                k3, neg_t.field_of_v(cid.reshape(-1))
            ).reshape(batch, W)

            w_lvl = jnp.arange(1, W + 1, dtype=jnp.float32)  # hop index
            alpha_b = (alpha / w_lvl)[None, :].repeat(batch, 0).reshape(-1)
            margin_b = (margin / w_lvl)[None, :].repeat(batch, 0).reshape(-1)

            w, _, loss = fbpr_step(
                state["vertex"], state["vertex"],
                jnp.broadcast_to(vid[:, None], (batch, W)).reshape(-1),
                cid.reshape(-1),
                nid.reshape(-1, 1),
                alpha_b, margin_b,
                shared_table=True, collision=collision,
            )
            return {"vertex": w}, loss

        return step

    def train(
        self,
        sample_times: int = 10,
        walk_steps: int = 5,
        margin: float = 1.0,
        alpha: float = 0.025,
        batch: int = 4096,
        steps_per_call: int = 64,
        collision: str = "sum",
        verbose: bool = True,
    ) -> None:
        self.walk_steps = walk_steps
        self.margin = margin
        batch = clamp_batch(self.graph.n_vertices, batch)
        driver = TrainDriver(
            self._make_step(batch, collision),
            ctx=self._make_ctx(),
            samples_per_step=batch,
            alpha=alpha,
            total_samples=int(sample_times * 1_000_000),
            steps_per_call=steps_per_call,
            **self._ckpt_kw(),
        )
        self.state = driver.train(self.state, self._key(), verbose=verbose)
