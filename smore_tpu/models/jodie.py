"""JODIE: joint dynamic user-item embeddings.

Reference: /root/reference/internal/models/jodie/jodie.go + pkg/rnn.
Per epoch (jodie.go:230-296): dynamic tables reset to the STATIC copies,
then a strictly chronological scan over interactions; for each event
  1. BCE monitoring loss on sigmoid(u . i) vs one random negative item
     (:247-262 -- the loss is logged, it does NOT backprop in the
     reference)
  2. user update: u <- (1-lr)*u + lr*tanh(Wh u + Wx [i|feat|dt/100] + b)
     via a fixed RNN cell (:122-160; the cell's own weights are never
     trained in the reference loop)
  3. symmetric item update (:162-200)
  4. static tables EMA toward dynamic at 0.1*lr (:276-281)
A projection RNN (input = dt/100) serves embedding projection (:108-119).

Design: the chronological dependency is inherent, so the scan runs as
ONE jitted lax.scan over the padded interaction array -- no Python per
event. Evaluation hook EvaluatePredictions (jodie.go:356-399): pairwise
accuracy pos > random-neg over the last <=1000 interactions.
"""

from __future__ import annotations

from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from smore_tpu.graph.bipartite import InteractionGraph
from smore_tpu.io.embeddings import save_embeddings
from smore_tpu.ops.rnn import init_rnn_cell, rnn_forward


def _rnn_params(key, in_dim, hid, scale=0.1):
    # standalone cell (ops/rnn.py = the reference's pkg/rnn); JODIE uses
    # the tighter 0.1 init its quality gates were tuned at
    return init_rnn_cell(key, in_dim, hid, scale=scale)


def _rnn_forward(p, h, x):
    return rnn_forward(p, h, x)


class JODIE:
    def __init__(self, ig: InteractionGraph, seed: int = 0):
        self.ig = ig
        self.seed = seed
        self.state: Dict[str, jnp.ndarray] = {}
        self.dim = 0

    @classmethod
    def load_interactions(cls, path: str, **kw):
        return cls(InteractionGraph.load_interactions(path), **kw)

    def init(self, dim: int) -> None:
        self.dim = dim
        ig = self.ig
        k = jax.random.PRNGKey(self.seed)
        ku, ki, k1, k2, k3 = jax.random.split(k, 5)
        scale = 1.0 / dim
        ue = (jax.random.uniform(ku, (ig.n_users, dim)) - 0.5) * scale
        ie = (jax.random.uniform(ki, (ig.n_items, dim)) - 0.5) * scale
        in_dim = dim + ig.feature_dim + 1
        self.state = {
            "user_static": ue,
            "item_static": ie,
            "user_rnn": _rnn_params(k1, in_dim, dim),
            "item_rnn": _rnn_params(k2, in_dim, dim),
            "proj_rnn": _rnn_params(k3, 1, dim),
        }
        # filled by train():
        self.user_dyn = ue
        self.item_dyn = ie

    def _epoch_fn(self):
        ig = self.ig
        uid = jnp.asarray(ig.user_ids)
        iid = jnp.asarray(ig.item_ids)
        ts = jnp.asarray(ig.timestamps)
        feats = (
            jnp.asarray(ig.features)
            if ig.features is not None
            else jnp.zeros((ig.n_interactions, 0), jnp.float32)
        )
        n_items = ig.n_items
        min_time = ig.min_time

        def epoch(state, key, lr, bce_lr):
            ue0 = state["user_static"]
            ie0 = state["item_static"]
            up, ip = state["user_rnn"], state["item_rnn"]
            negs = jax.random.randint(
                key, (ig.n_interactions,), 0, n_items
            )

            def body(carry, ev):
                ue, ie, us, is_, ult, ilt, loss_sum = carry
                u, i, t, f, neg = ev
                uvec = ue[u]
                ivec = ie[i]
                # BCE vs one random negative. The reference only LOGS
                # this loss (jodie.go:247-262); here it also backprops
                # into the event's rows (the actual JODIE training
                # signal) -- a strict upgrade, disable with bce_lr=0.
                nvec = ie[neg]
                p_pos = jax.nn.sigmoid(uvec @ ivec)
                p_neg = jax.nn.sigmoid(uvec @ nvec)
                loss = -jnp.log(p_pos + 1e-10) - jnp.log(1 - p_neg + 1e-10)
                du = bce_lr * ((1 - p_pos) * ivec - p_neg * nvec)
                di = bce_lr * (1 - p_pos) * uvec
                dn = -bce_lr * p_neg * uvec
                uvec = uvec + du
                ivec = ivec + di
                ue = ue.at[u].set(uvec)
                ie = ie.at[i].set(ivec).at[neg].add(dn)

                dt_u = (t - ult[u]) / 100.0
                dt_i = (t - ilt[i]) / 100.0
                xu = jnp.concatenate([ivec, f, dt_u[None]])
                xi = jnp.concatenate([uvec, f, dt_i[None]])
                new_u = (1 - lr) * uvec + lr * _rnn_forward(up, uvec, xu)
                new_i = (1 - lr) * ivec + lr * _rnn_forward(ip, ivec, xi)
                ue = ue.at[u].set(new_u)
                ie = ie.at[i].set(new_i)
                us = us.at[u].add(0.1 * lr * (new_u - us[u]))
                is_ = is_.at[i].add(0.1 * lr * (new_i - is_[i]))
                ult = ult.at[u].set(t)
                ilt = ilt.at[i].set(t)
                return (ue, ie, us, is_, ult, ilt, loss_sum + loss), None

            init = (
                ue0,
                ie0,
                ue0,
                ie0,
                jnp.full((ig.n_users,), min_time, jnp.float32),
                jnp.full((ig.n_items,), min_time, jnp.float32),
                jnp.float32(0.0),
            )
            (ue, ie, us, is_, _, _, loss_sum), _ = jax.lax.scan(
                body, init, (uid, iid, ts, feats, negs)
            )
            return ue, ie, us, is_, loss_sum / ig.n_interactions

        return jax.jit(epoch)

    def train(self, epochs: int = 5, learning_rate: float = 0.01,
              bce_lr: float = None, verbose: bool = True,
              checkpoint: str = None, checkpoint_every: int = 1,
              resume: bool = True) -> None:
        """checkpoint: checkpoint dir — static tables + RNN params + the final
        dynamic tables + PRNG chain, saved every ``checkpoint_every``
        epochs; resume continues the exact trajectory (each epoch resets
        dynamics to the statics, jodie.go:230-296, so epoch granularity
        is the natural unit)."""
        if bce_lr is None:
            bce_lr = learning_rate
        epoch_fn = self._epoch_fn()
        key = jax.random.PRNGKey(self.seed + 1)
        state = self.state
        ue = ie = None
        start_ep = 0
        if checkpoint:
            from smore_tpu.utils.checkpoint import (
                checkpoint_exists, load_checkpoint, save_checkpoint)

            if resume and checkpoint_exists(checkpoint):
                loaded, done_ep, extra = load_checkpoint(checkpoint)
                state = jax.tree.map(jnp.asarray, loaded["s"])
                ue = jnp.asarray(loaded["ue"])
                ie = jnp.asarray(loaded["ie"])
                if extra and "key" in extra:
                    key = jnp.asarray(
                        np.asarray(extra["key"]).astype(np.uint32))
                start_ep = min(int(done_ep), epochs)
        for ep in range(start_ep, epochs):
            key, ke = jax.random.split(key)
            ue, ie, us, is_, loss = epoch_fn(
                state, ke, jnp.float32(learning_rate), jnp.float32(bce_lr)
            )
            state = dict(state)
            state["user_static"] = us
            state["item_static"] = is_
            if verbose:
                print(f"\tepoch {ep + 1}/{epochs} BCE={float(loss):.4f}",
                      end="\r", flush=True)
            if checkpoint and (
                (ep + 1) % max(1, checkpoint_every) == 0
                or ep + 1 == epochs
            ):
                save_checkpoint(
                    checkpoint,
                    jax.device_get({"s": state, "ue": ue, "ie": ie}),
                    step=ep + 1,
                    extra={"key": np.asarray(key)},
                )
        if verbose:
            print()
        self.state = state
        if ue is not None:
            self.user_dyn, self.item_dyn = ue, ie

    def project(self, user_emb: jnp.ndarray, dt: float) -> jnp.ndarray:
        """projectEmbedding (jodie.go:108-119)."""
        if dt <= 0:
            return user_emb
        return _rnn_forward(
            self.state["proj_rnn"], user_emb,
            jnp.asarray([dt / 100.0], jnp.float32),
        )

    def evaluate_predictions(self, tail: int = 1000) -> float:
        """jodie.go:356-399: fraction of the last <=tail interactions
        where sigma(u.i_pos) > sigma(u.i_rand)."""
        ig = self.ig
        n = min(tail, max(1, ig.n_interactions // 5))
        u = np.asarray(ig.user_ids[-n:])
        i = np.asarray(ig.item_ids[-n:])
        ue = np.asarray(self.user_dyn)
        ie = np.asarray(self.item_dyn)
        rng = np.random.default_rng(0)
        neg = rng.integers(0, ig.n_items, n)
        s_pos = np.einsum("nd,nd->n", ue[u], ie[i])
        s_neg = np.einsum("nd,nd->n", ue[u], ie[neg])
        return float((s_pos > s_neg).mean())

    def save_weights(self, user_file: str, item_file: str) -> None:
        save_embeddings(user_file, self.ig.users, np.asarray(self.user_dyn))
        save_embeddings(item_file, self.ig.items, np.asarray(self.item_dyn))
