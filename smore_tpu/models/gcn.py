"""GCN and TextGCN: sampled neighbor-sum CBOW models.

Reference:
  - GCN: /root/reference/src/model/GCN.cpp (Train :62-118): field-0
    sources, UpdateCBOW(v1, v1) -- both sides aggregate sampled 1-hop
    neighborhoods of v1.
  - TEXTGCN: /root/reference/src/model/TEXTGCN.cpp (Train :89-144):
    fields are 0=doc, 1=filtered, 2=word; v1 = field-0 doc,
    v2 = TargetSample(v1), UpdateCBOW(v2, v1). SaveWeights (:20-49)
    writes docs as the SUM of their neighbors' vertex rows, words as
    their own rows, and skips field-1 vertices.

Negative sets are uniform draws over field-1 vertices (UpdateCBOW's
rejection loop, proNet.cpp:2952-2956); on a graph without field metadata
they fall back to uniform over all vertices.
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
    zeros_embedding,
)
from smore_tpu.io.embeddings import save_embeddings
from smore_tpu.ops.community import cbow_step, cbow_step_shared_negs
from smore_tpu.sampling.fields import FieldTables


class GCN(PairModelBase):
    src_field = 0
    neg_field = 1

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

    def load_field_meta(self, path: str) -> None:
        self.graph.load_field_meta(path)

    def _make_ctx(self):
        g = self.graph
        src_t = FieldTables.build(g, weights=g.out_degree)
        neg_t = FieldTables.build(g, weights=np.ones(g.n_vertices))
        return (self.build_sampler(), src_t, neg_t)

    def _make_step(self, batch, negatives, collision,
                   shared_negatives=0):
        S = self.walk_steps
        reg = self.reg
        has_fields = self.graph.n_fields > 1
        nf = self.neg_field if has_fields else 0
        Kp = shared_negatives

        def step(state, ctx, key, alpha):
            tables, src_t, neg_t = ctx
            k1, k2, k3, k4 = jax.random.split(key, 4)
            vert, cont = self._sample_vc(tables, src_t, k1, batch)

            # S independent 1-hop draws per side (UpdateCBOW's
            # TargetSample loops -- NOT a walk)
            u = jax.random.uniform(k2, (batch, 2 * S, 2))
            vctx = jnp.stack(
                [tables.target_sample(None, vert, u2=u[:, i]) for i in range(S)],
                axis=1,
            )
            cctx = jnp.stack(
                [
                    tables.target_sample(None, cont, u2=u[:, S + i])
                    for i in range(S)
                ],
                axis=1,
            )
            mask = (
                tables.vert_meta.at[vert].get(mode="promise_in_bounds")[:, 1]
                > 0
            ).astype(jnp.float32) * (
                tables.vert_meta.at[cont].get(mode="promise_in_bounds")[:, 1]
                > 0
            ).astype(jnp.float32)

            if Kp:
                # ONE pool of Kp negative sets scored against the whole
                # batch as one matmul (exactly expectation-preserving: the
                # CBOW gradient is additive in negative sets) -- removes
                # the K*S rows/sample that dominate the step
                pool = neg_t.negative_field_sample(
                    k3, jnp.full((Kp, S), nf, dtype=jnp.int32),
                )
                w, loss = cbow_step_shared_negs(
                    state["vertex"], vctx, cctx, pool, alpha,
                    k_equiv=negatives, reg=reg, mask=mask,
                    collision=collision,
                )
                return {"vertex": w, "context": state["context"]}, loss
            negs = neg_t.negative_field_sample(
                k3,
                jnp.full((batch, negatives, S), nf, dtype=jnp.int32),
            )
            w, loss = cbow_step(
                state["vertex"], vctx, cctx, negs, alpha, reg=reg,
                mask=mask, collision=collision,
            )
            return {"vertex": w, "context": state["context"]}, loss

        return step

    def _sample_vc(self, tables, src_t, key, batch):
        zeros = jnp.full((batch,), self.src_field, dtype=jnp.int32)
        v1 = src_t.negative_field_sample(key, zeros)
        return v1, v1

    def train(
        self,
        sample_times: int = 10,
        walk_steps: int = 5,
        negative_samples: int = 5,
        reg: float = 0.01,
        alpha: float = 0.025,
        batch: int = 2048,
        steps_per_call: int = 64,
        collision: str = "sum",
        shared_negatives: int = 128,  # Kp-SET shared pool per step
        # (cbow_step_shared_negs; 0 = per-sample reference sets).
        # Exactly expectation-preserving (additive sigmoid gradient);
        # zoo-gated at AUC parity (PERF_NOTES round-5).
        verbose: bool = True,
    ) -> None:
        self.walk_steps = walk_steps
        self.reg = reg
        # CBOW aggregates 2*S neighbor rows per sample, so the stale-
        # snapshot overshoot kicks in at batch ~ n/(2S) rather than ~n
        # (diverges on the toy nets otherwise); production configs are
        # unaffected (50k-vertex graph: bound 5000 > default 2048).
        batch = clamp_batch(
            max(1, self.graph.n_vertices // (2 * walk_steps)), batch
        )
        if self.graph.n_vertices <= 4 * walk_steps:
            # graph smaller than one sample's neighbor bag: collisions are
            # unavoidable even at batch=1, "sum" oscillates and diverges
            collision = "mean"
        if shared_negatives and self.graph.n_vertices < 4 * shared_negatives:
            # tiny-graph guard: a pool drawn (with replacement) from a
            # vertex set not much larger than itself concentrates the
            # whole batch's negative mass on a few rows per step --
            # sum-collision overshoot (NaN on the toy nets). Fall back
            # to per-sample negatives there; production graphs are
            # unaffected.
            shared_negatives = 0
        if shared_negatives:
            shared_negatives = min(shared_negatives, batch)
        driver = TrainDriver(
            self._make_step(batch, negative_samples, collision,
                            shared_negatives),
            ctx=self._make_ctx(),
            samples_per_step=batch,
            alpha=alpha,
            total_samples=int(sample_times * 1_000_000),
            steps_per_call=steps_per_call,
            **self._ckpt_kw(),
        )
        self.state = driver.train(self.state, self._key(), verbose=verbose)


class TEXTGCN(GCN):
    """Doc-word CBOW; vertex side = TargetSample(doc), context side = doc."""

    def _sample_vc(self, tables, src_t, key, batch):
        k1, k2 = jax.random.split(key)
        zeros = jnp.full((batch,), self.src_field, dtype=jnp.int32)
        v1 = src_t.negative_field_sample(k1, zeros)
        v2 = tables.target_sample(k2, v1)
        return v2, v1

    def save_weights(self, path: str, table: str = "vertex") -> None:
        """TEXTGCN::SaveWeights: docs (field 0) = sum of neighbor rows,
        words (field 2) = own row, field-1 vertices skipped."""
        g = self.graph
        wv = np.asarray(self.state["vertex"])
        fields = (
            g.fields if g.fields is not None else np.zeros(g.n_vertices, int)
        )
        names, rows = [], []
        for vid, nm in enumerate(g.names):
            f = int(fields[vid])
            if f == 1:
                continue
            names.append(nm)
            if f == 0:
                nbrs = g.neighbors(vid)
                rows.append(
                    wv[nbrs].sum(axis=0)
                    if len(nbrs)
                    else np.zeros(self.dim, np.float32)
                )
            else:
                rows.append(wv[vid])
        save_embeddings(path, names, np.asarray(rows, dtype=np.float32))


class TEXTGCNdev(GCN):
    """Event/word CBOW variant (TEXTGCNdev).

    Reference: /root/reference/src/model/TEXTGCNdev.cpp with kernel
    proNet::UpdateCBOWdev (proNet.cpp:2755-2866). Fields: 0=user,
    1=event, 2=word. Per field-0 user:
      - bags = num_events x num_words word draws (2 hops: user->event->
        word); w_avg = SUM of w_context[word] rows
      - the LAST sampled event is paired (num_events times -- reference
        quirk preserved) with (a) w_avg and (b) the user row, sigmoid-CE
        label 1 with reg; negatives are field-1 events vs both
      - event rows update in place (w_vertex); the accumulated w_avg-side
        error lands on every bag word (w_context); the user row gets the
        user-side error
    SaveWeights (TEXTGCNdev.cpp:6-30): users from w_vertex, words from
    w_context, events skipped; header counts only written rows.
    """

    def __init__(self, graph, seed: int = 0):
        super().__init__(graph, seed)
        self.num_events = 5
        self.num_words = 5

    def _make_step(self, batch, negatives, collision,
                   shared_negatives=0):
        E = self.num_events
        Wn = self.num_words
        reg = self.reg
        has_fields = self.graph.n_fields > 1
        nf = 1 if has_fields else 0
        Kp = shared_negatives

        def step(state, ctx, key, alpha):
            tables, src_t, neg_t = ctx
            k1, k2, k3 = jax.random.split(key, 3)
            zeros = jnp.zeros((batch,), dtype=jnp.int32)
            user = src_t.negative_field_sample(k1, zeros)

            u = jax.random.uniform(k2, (batch, E * (1 + Wn), 2))
            events, words = [], []
            for e in range(E):
                ev = tables.target_sample(None, user, u2=u[:, e * (1 + Wn)])
                events.append(ev)
                for w in range(Wn):
                    words.append(
                        tables.target_sample(
                            None, ev, u2=u[:, e * (1 + Wn) + 1 + w]
                        )
                    )
            bags = jnp.stack(words, axis=1)  # (B, E*Wn)
            last_ev = events[-1]

            wv, wc = state["vertex"], state["context"]
            w_avg = jnp.sum(
                wc.at[bags].get(mode="promise_in_bounds"), axis=1
            )  # (B, D)
            ev_row = wv.at[last_ev].get(mode="promise_in_bounds")
            u_row = wv.at[user].get(mode="promise_in_bounds")

            # positive (event, w_avg) and (event, user), repeated E times
            g1 = 1.0 - jax.nn.sigmoid(jnp.einsum("bd,bd->b", ev_row, w_avg))
            g2 = 1.0 - jax.nn.sigmoid(jnp.einsum("bd,bd->b", ev_row, u_row))
            d_ev = alpha * E * (
                g1[:, None] * w_avg + g2[:, None] * u_row - 2 * reg * ev_row
            )
            back_err = alpha * E * (g1[:, None] * ev_row - reg * w_avg)
            user_err = alpha * E * (g2[:, None] * ev_row - reg * u_row)

            from smore_tpu.ops.update import scatter_apply

            B = batch
            K = negatives
            D = w_avg.shape[1]
            if Kp:
                # ONE shared pool of field-1 events scored against both
                # anchors as one matmul (sigmoid gradient is additive in
                # negatives -> exactly expectation-preserving at
                # k_equiv/Kp scale)
                scale = K / Kp
                pool = neg_t.negative_field_sample(
                    k3, jnp.full((Kp,), nf, dtype=jnp.int32)
                )
                nvp = wv.at[pool].get(mode="promise_in_bounds")  # (Kp,D)
                gn1 = -jax.nn.sigmoid(w_avg @ nvp.T) * scale  # (B,Kp)
                gn2 = -jax.nn.sigmoid(u_row @ nvp.T) * scale
                back_err = back_err + alpha * E * (gn1 @ nvp)
                user_err = user_err + alpha * E * (gn2 @ nvp)
                d_pool = alpha * E * (
                    gn1.T @ w_avg + gn2.T @ u_row
                    - reg * 2 * B * scale * nvp
                )
                wv = scatter_apply(
                    wv,
                    [(last_ev, d_ev), (user, user_err), (pool, d_pool)],
                    collision,
                )
            else:
                # negatives: field-1 events vs w_avg and vs user
                negs = neg_t.negative_field_sample(
                    k3, jnp.full((batch, negatives, 2), nf,
                                 dtype=jnp.int32)
                )
                nv = wv.at[negs].get(mode="promise_in_bounds")
                gn1 = -jax.nn.sigmoid(
                    jnp.einsum("bkd,bd->bk", nv[:, :, 0], w_avg))
                gn2 = -jax.nn.sigmoid(
                    jnp.einsum("bkd,bd->bk", nv[:, :, 1], u_row))
                d_n1 = alpha * E * (
                    gn1[..., None] * w_avg[:, None] - reg * nv[:, :, 0]
                )
                d_n2 = alpha * E * (
                    gn2[..., None] * u_row[:, None] - reg * nv[:, :, 1]
                )
                back_err = back_err + alpha * E * jnp.einsum(
                    "bk,bkd->bd", gn1, nv[:, :, 0]
                )
                user_err = user_err + alpha * E * jnp.einsum(
                    "bk,bkd->bd", gn2, nv[:, :, 1]
                )
                wv = scatter_apply(
                    wv,
                    [
                        (last_ev, d_ev),
                        (user, user_err),
                        (negs[:, :, 0].reshape(-1),
                         d_n1.reshape(B * K, D)),
                        (negs[:, :, 1].reshape(-1),
                         d_n2.reshape(B * K, D)),
                    ],
                    collision,
                )
            S = bags.shape[1]
            wc = scatter_apply(
                wc,
                [(bags.reshape(-1),
                  jnp.broadcast_to(back_err[:, None], (B, S, D)).reshape(B * S, D))],
                collision,
            )
            eps = 1e-7
            loss = -jnp.log(
                jax.nn.sigmoid(jnp.einsum("bd,bd->b", ev_row, w_avg)) + eps
            ).mean()
            return {"vertex": wv, "context": wc}, loss

        return step

    def train(
        self,
        sample_times: int = 10,
        num_events: int = 5,
        num_words: int = 5,
        negative_samples: int = 5,
        reg: float = 0.01,
        alpha: float = 0.025,
        batch: int = 2048,
        steps_per_call: int = 64,
        collision: str = "sum",
        shared_negatives: int = 128,  # Kp-row shared event pool scored
        # against both anchors as one matmul (exactly expectation-
        # preserving: additive sigmoid gradient); 0 = per-sample
        verbose: bool = True,
    ) -> None:
        self.num_events = num_events
        self.num_words = num_words
        self.reg = reg
        from smore_tpu.models.base import TrainDriver

        # see GCN.train: CBOW fan-out lowers the stable batch bound
        batch = clamp_batch(
            max(1, self.graph.n_vertices // (num_events + num_words)), batch
        )
        if self.graph.n_vertices <= num_events * num_words:
            # word bag bigger than the graph: within-sample collisions are
            # unavoidable, "sum" oscillates and diverges even at batch=1
            collision = "mean"
        if shared_negatives and self.graph.n_vertices < 4 * shared_negatives:
            # tiny-graph guard: a pool drawn (with replacement) from a
            # vertex set not much larger than itself concentrates the
            # whole batch's negative mass on a few rows per step --
            # sum-collision overshoot (NaN on the toy nets). Fall back
            # to per-sample negatives there; production graphs are
            # unaffected.
            shared_negatives = 0
        if shared_negatives:
            shared_negatives = min(shared_negatives, batch)
        driver = TrainDriver(
            self._make_step(batch, negative_samples, collision,
                            shared_negatives),
            ctx=self._make_ctx(),
            samples_per_step=batch,
            alpha=alpha,
            total_samples=int(sample_times * 1_000_000),
            steps_per_call=steps_per_call,
            **self._ckpt_kw(),
        )
        self.state = driver.train(self.state, self._key(), verbose=verbose)

    def save_weights(self, path: str, table: str = "vertex") -> None:
        g = self.graph
        wv = np.asarray(self.state["vertex"])
        wc = np.asarray(self.state["context"])
        fields = (
            g.fields if g.fields is not None else np.zeros(g.n_vertices, int)
        )
        names, rows = [], []
        for vid, nm in enumerate(g.names):
            f = int(fields[vid])
            if f == 1:
                continue
            names.append(nm)
            rows.append(wv[vid] if f == 0 else wc[vid])
        save_embeddings(path, names, np.asarray(rows, dtype=np.float32))
