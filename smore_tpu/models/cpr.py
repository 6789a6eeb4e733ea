"""CPR (cross-domain preference ranking) and TPR (text-aware preference
ranking).

Reference:
  - CPR: /root/reference/internal/models/cpr/cpr.go -- two graphs
    (target + source domain). User representation = MEAN of {user row,
    every owned target item row, every owned source item row}
    (:128-172). Margin-BPR on the TARGET domain only (:217-277; source
    items influence through the aggregation); gradients flow to the
    user row and the target pos/neg item rows; L2 user_reg/item_reg.
    SaveWeights -> three files (:296-360).
  - TPR: /root/reference/internal/models/tpr/tpr.go -- user-item graph +
    item-word graph. Item representation = (1-w)*item + w*MEAN(words)
    (:101-120); BPR over enriched items with lambda L2; saves
    user/item/word tables.

Batched adaptation (documented): the reference aggregates a user's FULL item
list / an item's FULL word list (ragged); here a fixed-size uniform
sample of S neighbors estimates the mean so shapes stay static, and
gradients come from jax.grad of the same loss (which also trains the
aggregated rows -- a superset of the reference's manual updates).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from smore_tpu.graph.graph import Graph
from smore_tpu.io.embeddings import save_embeddings
from smore_tpu.models.base import clamp_batch, TrainDriver, init_embedding
from smore_tpu.sampling.tables import SamplerTables


def _sample_neighbors(tables: SamplerTables, key, vids, S: int):
    """S independent 1-hop draws per vid + count mask (0 for isolated)."""
    u = jax.random.uniform(key, tuple(vids.shape) + (S, 2))
    deg = tables.vert_meta.at[vids].get(mode="promise_in_bounds")[..., 1]
    nbrs = jnp.stack(
        [tables.target_sample(None, vids, u2=u[..., i, :]) for i in range(S)],
        axis=-1,
    )  # (..., S)
    return nbrs, (deg > 0).astype(jnp.float32)


class CPR:
    def __init__(self, target: Graph, source: Graph, seed: int = 0,
                 user_reg: float = 0.01, item_reg: float = 0.01,
                 margin: float = 1.0, agg_samples: int = 8):
        self.target = target
        self.source = source
        self.seed = seed
        self.user_reg = user_reg
        self.item_reg = item_reg
        self.margin = margin
        self.agg_samples = agg_samples
        self.state = {}
        self.dim = 0

    @classmethod
    def load_domains(cls, target_path: str, source_path: str,
                     undirected: bool = True, **kw):
        return cls(
            Graph.load_edge_list(target_path, undirected=undirected),
            Graph.load_edge_list(source_path, undirected=undirected),
            **kw,
        )

    def init(self, dim: int) -> None:
        self.dim = dim
        n_user = max(self.target.n_vertices, self.source.n_vertices)
        k1, k2, k3 = jax.random.split(jax.random.PRNGKey(self.seed), 3)
        self.state = {
            "user": init_embedding(k1, n_user, dim),
            "target": init_embedding(k2, self.target.n_vertices, dim),
            "source": init_embedding(k3, self.source.n_vertices, dim),
        }

    def _make_ctx(self):
        return (
            SamplerTables.build(self.target),
            SamplerTables.build(self.source),
        )

    def _make_step(self, batch, collision):
        S = self.agg_samples
        margin = self.margin
        u_reg, i_reg = self.user_reg, self.item_reg

        def loss_fn(state, uid, pos, neg, t_nbrs, t_m, s_nbrs, s_m, alpha):
            uvec = state["user"].at[uid].get(mode="promise_in_bounds")
            t_rows = state["target"].at[t_nbrs].get(mode="promise_in_bounds")
            s_rows = state["source"].at[s_nbrs].get(mode="promise_in_bounds")
            # mean over {user} + sampled target items + sampled source items
            total = 1.0 + t_m * S + s_m * S
            agg = (
                uvec
                + t_rows.sum(1) * t_m[:, None]
                + s_rows.sum(1) * s_m[:, None]
            ) / total[:, None]

            pi = state["target"].at[pos].get(mode="promise_in_bounds")
            ni = state["target"].at[neg].get(mode="promise_in_bounds")
            diff = jnp.einsum("bd,bd->b", agg, pi - ni)
            # margin BPR: active when diff < margin, softplus grad shape
            active = (diff < margin).astype(jnp.float32)
            loss = jnp.sum(jax.nn.softplus(-(diff - margin)) * active)
            reg = u_reg * jnp.sum(uvec * uvec) + i_reg * (
                jnp.sum(pi * pi) + jnp.sum(ni * ni)
            )
            return loss + reg

        grad_fn = jax.grad(loss_fn)

        def step(state, ctx, key, alpha):
            t_tab, s_tab = ctx
            k1, k2, k3, k4, k5 = jax.random.split(key, 5)
            uid = t_tab.source_sample(k1, (batch,))
            pos = t_tab.target_sample(k2, uid)
            neg = t_tab.negative_sample(k3, (batch,))
            t_nbrs, t_m = _sample_neighbors(t_tab, k4, uid, self.agg_samples)
            s_nbrs, s_m = _sample_neighbors(s_tab, k5, uid, self.agg_samples)
            g = grad_fn(state, uid, pos, neg, t_nbrs, t_m, s_nbrs, s_m, alpha)
            state = {k_: v - alpha * g[k_] for k_, v in state.items()}
            return state, jnp.float32(0.0)

        return step

    def train(self, update_times: int = 10, alpha: float = 0.025,
              batch: int = 4096, steps_per_call: int = 64,
              collision: str = "sum", verbose: bool = True,
              checkpoint: str = None, checkpoint_every: int = 1,
              resume: bool = True) -> None:
        batch = clamp_batch(
            min(self.target.n_vertices, self.source.n_vertices), batch
        )
        driver = TrainDriver(
            self._make_step(batch, collision),
            ctx=self._make_ctx(),
            samples_per_step=batch,
            alpha=alpha,
            total_samples=int(update_times * 1_000_000),
            steps_per_call=steps_per_call,
            checkpoint_path=checkpoint,
            checkpoint_every=checkpoint_every,
            resume=resume,
        )
        self.state = driver.train(
            self.state, jax.random.PRNGKey(self.seed), verbose=verbose
        )

    def save_weights(self, user_file: str, target_file: str,
                     source_file: str) -> None:
        n_user = self.state["user"].shape[0]
        user_names = [
            self.target.names[i] if i < self.target.n_vertices else f"_u{i}"
            for i in range(n_user)
        ]
        save_embeddings(user_file, user_names, np.asarray(self.state["user"]))
        save_embeddings(
            target_file, self.target.names, np.asarray(self.state["target"])
        )
        save_embeddings(
            source_file, self.source.names, np.asarray(self.state["source"])
        )


class TPR:
    def __init__(self, ui: Graph, iw: Graph, seed: int = 0,
                 text_weight: float = 0.3, lam: float = 0.01,
                 agg_samples: int = 8):
        self.ui = ui
        self.iw = iw
        self.seed = seed
        self.text_weight = text_weight
        self.lam = lam
        self.agg_samples = agg_samples
        self.state = {}
        self.dim = 0

    @classmethod
    def load_graphs(cls, ui_path: str, iw_path: str,
                    undirected: bool = True, **kw):
        return cls(
            Graph.load_edge_list(ui_path, undirected=undirected),
            Graph.load_edge_list(iw_path, undirected=undirected),
            **kw,
        )

    def init(self, dim: int) -> None:
        self.dim = dim
        k1, k2, k3 = jax.random.split(jax.random.PRNGKey(self.seed), 3)
        self.state = {
            "user": init_embedding(k1, self.ui.n_vertices, dim),
            "item": init_embedding(k2, self.ui.n_vertices, dim),
            "word": init_embedding(k3, self.iw.n_vertices, dim),
        }

    def _make_ctx(self):
        # ui-item id -> iw-graph id by NAME (the Go reference reuses the
        # ui id directly, tpr.go:110, which only works when the interning
        # orders happen to agree; the name map is the robust form)
        ui2iw = np.array(
            [self.iw.name2id.get(nm, -1) for nm in self.ui.names],
            dtype=np.int32,
        )
        return (
            SamplerTables.build(self.ui),
            SamplerTables.build(self.iw),
            jnp.asarray(ui2iw),
        )

    def _enrich(self, state, items, w_nbrs, w_m):
        """(1-w)*item + w*mean(sampled words); plain item row if no words
        (tpr.go:101-120)."""
        tw = self.text_weight
        it = state["item"].at[items].get(mode="promise_in_bounds")
        words = state["word"].at[w_nbrs].get(mode="promise_in_bounds")
        enriched = (1.0 - tw) * it + tw * words.mean(1)
        return jnp.where(w_m[:, None] > 0, enriched, it)

    def _make_step(self, batch, collision):
        lam = self.lam
        S = self.agg_samples

        def loss_fn(state, uid, pos, neg, pw, pw_m, nw, nw_m):
            u = state["user"].at[uid].get(mode="promise_in_bounds")
            pi = self._enrich(state, pos, pw, pw_m)
            ni = self._enrich(state, neg, nw, nw_m)
            diff = jnp.einsum("bd,bd->b", u, pi - ni)
            loss = jnp.sum(jax.nn.softplus(-diff))
            reg = lam * (
                jnp.sum(u * u) + jnp.sum(pi * pi) + jnp.sum(ni * ni)
            )
            return loss + reg

        grad_fn = jax.grad(loss_fn)

        def step(state, ctx, key, alpha):
            ui_tab, iw_tab, ui2iw = ctx
            k1, k2, k3, k4, k5 = jax.random.split(key, 5)
            uid = ui_tab.source_sample(k1, (batch,))
            pos = ui_tab.target_sample(k2, uid)
            neg = ui_tab.negative_sample(k3, (batch,))
            p_iw = ui2iw.at[pos].get(mode="promise_in_bounds")
            n_iw = ui2iw.at[neg].get(mode="promise_in_bounds")
            pw, pw_m = _sample_neighbors(iw_tab, k4, jnp.maximum(p_iw, 0), S)
            nw, nw_m = _sample_neighbors(iw_tab, k5, jnp.maximum(n_iw, 0), S)
            pw_m = pw_m * (p_iw >= 0)
            nw_m = nw_m * (n_iw >= 0)
            g = grad_fn(state, uid, pos, neg, pw, pw_m, nw, nw_m)
            state = {k_: v - alpha * g[k_] for k_, v in state.items()}
            return state, jnp.float32(0.0)

        return step

    def train(self, sample_times: int = 10, alpha: float = 0.025,
              batch: int = 4096, steps_per_call: int = 64,
              collision: str = "sum", verbose: bool = True,
              checkpoint: str = None, checkpoint_every: int = 1,
              resume: bool = True) -> None:
        batch = clamp_batch(
            min(self.ui.n_vertices, self.iw.n_vertices), batch
        )
        driver = TrainDriver(
            self._make_step(batch, collision),
            ctx=self._make_ctx(),
            samples_per_step=batch,
            alpha=alpha,
            total_samples=int(sample_times * 1_000_000),
            steps_per_call=steps_per_call,
            checkpoint_path=checkpoint,
            checkpoint_every=checkpoint_every,
            resume=resume,
        )
        self.state = driver.train(
            self.state, jax.random.PRNGKey(self.seed), verbose=verbose
        )

    def save_weights(self, user_file: str, item_file: str,
                     word_file: str) -> None:
        save_embeddings(user_file, self.ui.names, np.asarray(self.state["user"]))
        save_embeddings(item_file, self.ui.names, np.asarray(self.state["item"]))
        save_embeddings(word_file, self.iw.names, np.asarray(self.state["word"]))
