"""Knowledge-graph embedding models: TransE, RotatE, ComplEx.

Reference: /root/reference/internal/models/{transe,rotate,complex}/*.go.
All three are margin-ranking models over corrupted triples:

  TransE  score = ||h + r - t||_{1 or 2}       (transe.go:102-121)
  RotatE  score = ||h o r - t||_2, r unit-modulus complex
          + self-adversarial neg weight exp(-negScore/T) (rotate.go:98-113,
          :180-204)
  ComplEx score = Re<h, r, conj(t)> (higher = better), margin on
          (margin + neg - pos) (complex.go:85-101,:241-252), entities
          renormalized to unit length after updates (:104-117)

Design differences (documented, quality-gated):
  - gradients come from jax.grad of the same margin losses (the Go code
    hand-derives identical expressions, e.g. d||x||/dx = x/||x||)
  - the corrupted entity is a uniform draw from the reference's
    per-relation entity pool, as a segmented device array
  - RotatE relations are stored as PHASES, so unit modulus holds by
    construction (the reference renormalizes each epoch, rotate.go:84-93)
  - epoch-wise shuffling happens on device via jax.random.permutation;
    entity renorm runs between epochs like the reference
  - complex tensors are stored as (..., 2D) real arrays (re | im halves)

Save format (transe.go:287-327): separate entity/relation files, each in
the standard "N dim" text layout.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from smore_tpu.graph.knowledge import KnowledgeGraph
from smore_tpu.io.embeddings import save_embeddings
from smore_tpu.models.base import clamp_batch


def _uniform_init(key, rows, dim, scale):
    return jax.random.uniform(
        key, (rows, dim), minval=-scale, maxval=scale, dtype=jnp.float32
    )


class _KGBase:
    """Shared: epoch loop over shuffled triple batches, jitted step."""

    def __init__(self, kg: KnowledgeGraph, seed: int = 0, margin: float = 1.0):
        self.kg = kg
        self.seed = seed
        self.margin = margin
        self.state: Dict[str, jnp.ndarray] = {}
        self.dim = 0

    @classmethod
    def load_triples(cls, path: str, **kw):
        return cls(KnowledgeGraph.load_triples(path), **kw)

    # -- per-model hooks ------------------------------------------------ #
    def _score(self, state, h, r, t):
        """Batched score; LOWER = better fit unless _higher_is_better."""
        raise NotImplementedError

    def _update_score(self, state, h, r, t):
        """Score whose gradient is the APPLIED update direction; equals
        _score unless the reference hand-derives a different step."""
        return self._score(state, h, r, t)

    _higher_is_better = False

    def _init_state(self, key) -> Dict[str, jnp.ndarray]:
        raise NotImplementedError

    def _renorm(self, state):
        """Between-epoch normalization (entity unit sphere)."""
        ent = state["entity"]
        n = jnp.linalg.norm(ent, axis=1, keepdims=True)
        state = dict(state)
        state["entity"] = ent / jnp.maximum(n, 1e-12)
        return state

    def _adversarial_weight(self, neg_score):
        return None  # RotatE overrides

    # -- training ------------------------------------------------------- #
    def init(self, dim: int) -> None:
        self.dim = dim
        self.state = self._init_state(jax.random.PRNGKey(self.seed))

    def _make_step(self, batch: int):
        kg = self.kg
        margin = self.margin
        triples = (
            jnp.asarray(kg.heads),
            jnp.asarray(kg.relations),
            jnp.asarray(kg.tails),
        )
        rel_indptr = jnp.asarray(kg.rel_indptr, dtype=jnp.int32)
        rel_entities = jnp.asarray(kg.rel_entities, dtype=jnp.int32)
        sign = -1.0 if self._higher_is_better else 1.0

        def corrupt(key, h, r, t):
            k1, k2 = jax.random.split(key)
            lo = rel_indptr.at[r].get(mode="promise_in_bounds")
            hi = rel_indptr.at[r + 1].get(mode="promise_in_bounds")
            size = jnp.maximum(hi - lo, 1)
            u = jax.random.uniform(k1, h.shape)
            cand = rel_entities.at[
                lo + jnp.minimum((u * size).astype(jnp.int32), size - 1)
            ].get(mode="promise_in_bounds")
            corrupt_head = jax.random.uniform(k2, h.shape) < 0.5
            nh = jnp.where(corrupt_head, cand, h)
            nt = jnp.where(corrupt_head, t, cand)
            return nh, nt

        def loss_fn(state, idx, key):
            h = triples[0].at[idx].get(mode="promise_in_bounds")
            r = triples[1].at[idx].get(mode="promise_in_bounds")
            t = triples[2].at[idx].get(mode="promise_in_bounds")
            nh, nt = corrupt(key, h, r, t)
            pos = sign * self._score(state, h, r, t)
            neg = sign * self._score(state, nh, r, nt)
            w = self._adversarial_weight(neg)
            gate = (margin + pos - neg) > 0
            # The margin VIOLATION test always uses _score; the applied
            # gradient comes from _update_score, which models override
            # when the reference's hand-derived step is not the plain
            # score gradient (RotatE's per-coordinate normalization,
            # rotate.go:231-249).
            pos_u = sign * self._update_score(state, h, r, t)
            neg_u = sign * self._update_score(state, nh, r, nt)
            term = pos_u - (
                neg_u * jax.lax.stop_gradient(w) if w is not None else neg_u
            )
            viol = jax.nn.relu(margin + pos - neg)
            if w is not None:
                viol = viol * jax.lax.stop_gradient(w)
            # SUM, not mean: the reference applies each triple's update at
            # the full learning rate (hogwild mass; see ops/update.py).
            return (
                jnp.sum(jnp.where(gate, term, 0.0)),
                jnp.mean(jax.lax.stop_gradient(viol) > 0),
            )

        grad_fn = jax.value_and_grad(loss_fn, has_aux=True)

        def step(state, idx, key, lr):
            (loss, frac), grads = grad_fn(state, idx, key)
            state = {
                k: v - lr * grads[k] for k, v in state.items()
            }
            return state, loss

        return jax.jit(step, donate_argnums=(0,))

    def evaluate_link_prediction(self, test_triples: int = 1000,
                                 num_negatives: int = 10,
                                 seed: int = 0):
        """Rank each of the last ``test_triples`` true triples against
        ``num_negatives`` corrupted-head negatives; returns (MRR, hits@3)
        following the reference protocol (complex.go:321-364, where
        MRR = 1 / mean(rank))."""
        import jax.numpy as jnp

        kg = self.kg
        t = min(test_triples, kg.n_triples)
        h = jnp.asarray(kg.heads[-t:]);  r = jnp.asarray(kg.relations[-t:])
        tl = jnp.asarray(kg.tails[-t:])
        # Normalize to higher-is-better: TransE/RotatE _score is a
        # distance (lower = better fit), ComplEx a similarity.
        sign = 1.0 if self._higher_is_better else -1.0
        correct = sign * self._score(self.state, h, r, tl)  # (t,)
        rng = np.random.default_rng(seed)
        neg_h = jnp.asarray(
            rng.integers(0, kg.n_entities, (num_negatives, t))
        )
        neg = jnp.stack(
            [sign * self._score(self.state, neg_h[i], r, tl)
             for i in range(num_negatives)]
        )  # (K, t)
        better = (correct[None, :] > neg).sum(axis=0)  # (t,)
        rank = np.asarray(num_negatives - better + 1, dtype=np.float64)
        mrr = float(1.0 / rank.mean())
        hits3 = float((rank <= 3).mean())
        return mrr, hits3

    def train(
        self,
        epochs: int = 100,
        batch: int = 1024,
        alpha: float = 0.01,
        verbose: bool = True,
        checkpoint: str = None,
        checkpoint_every: int = 1,
        resume: bool = True,
    ) -> None:
        """checkpoint: checkpoint dir — entity/relation tables + PRNG chain
        saved every ``checkpoint_every`` epochs; with ``resume`` a
        same-``epochs`` restart continues the exact uninterrupted
        trajectory (the lr schedule is a pure function of the restored
        epoch counter and the run's total epochs). Resuming with a
        DIFFERENT ``epochs`` re-stretches the linear lr decay over the
        new total — a warning is printed when that happens."""
        kg = self.kg
        n = kg.n_triples
        batch = clamp_batch(min(n, kg.n_entities), batch)
        n_batches = max(1, n // batch)
        step = self._make_step(batch)
        renorm = jax.jit(self._renorm, donate_argnums=(0,))
        key = jax.random.PRNGKey(self.seed + 1)
        state = self.state
        alpha_min = alpha * 1e-4
        total = epochs * n_batches
        done = 0
        start_ep = 0
        if checkpoint:
            from smore_tpu.utils.checkpoint import (
                checkpoint_exists, load_checkpoint, save_checkpoint)

            if resume and checkpoint_exists(checkpoint):
                loaded, done_ep, extra = load_checkpoint(checkpoint)
                state = jax.tree.map(jnp.asarray, loaded)
                if extra and "key" in extra:
                    key = jnp.asarray(
                        np.asarray(extra["key"]).astype(np.uint32))
                start_ep = min(int(done_ep), epochs)
                done = start_ep * n_batches
                if extra and int(extra.get("epochs", epochs)) != epochs:
                    print(
                        f"\twarning: resuming with -epochs {epochs} but "
                        f"checkpoint was written by an -epochs "
                        f"{int(extra['epochs'])} run; the linear lr decay "
                        f"re-stretches over the new total",
                        flush=True,
                    )
        for ep in range(start_ep, epochs):
            key, kp = jax.random.split(key)
            perm = jax.random.permutation(kp, n)[: n_batches * batch]
            perm = perm.reshape(n_batches, batch)
            for b in range(n_batches):
                key, ks = jax.random.split(key)
                lr = max(alpha * (1.0 - done / total), alpha_min)
                state, loss = step(state, perm[b], ks, jnp.float32(lr))
                done += 1
            state = renorm(state)
            if verbose:
                print(
                    f"\tepoch {ep + 1}/{epochs} loss={float(loss):.5f}",
                    end="\r",
                    flush=True,
                )
            if checkpoint and (
                (ep + 1) % max(1, checkpoint_every) == 0
                or ep + 1 == epochs
            ):
                save_checkpoint(
                    checkpoint,
                    jax.device_get(state),
                    step=ep + 1,
                    extra={"key": np.asarray(key), "epochs": epochs},
                )
        if verbose:
            print()
        self.state = state

    # -- persistence ---------------------------------------------------- #
    def save_embeddings(self, entity_file: str, relation_file: str) -> None:
        save_embeddings(
            entity_file, self.kg.entities, np.asarray(self.state["entity"])
        )
        save_embeddings(
            relation_file,
            self.kg.relations_names,
            np.asarray(self._relation_out()),
        )

    def _relation_out(self):
        return self.state["relation"]


class TransE(_KGBase):
    def __init__(self, kg, seed: int = 0, margin: float = 1.0, norm: int = 2):
        super().__init__(kg, seed, margin)
        self.norm = norm

    def _init_state(self, key):
        k1, k2 = jax.random.split(key)
        dim = self.dim
        s = 6.0 / np.sqrt(dim)
        ent = _uniform_init(k1, self.kg.n_entities, dim, s)
        rel = _uniform_init(k2, self.kg.n_relations, dim, s)
        # reference normalizes entities at init (transe.go Init)
        ent = ent / jnp.maximum(jnp.linalg.norm(ent, axis=1, keepdims=True), 1e-12)
        return {"entity": ent, "relation": rel}

    def _score(self, state, h, r, t):
        e, w = state["entity"], state["relation"]
        d = (
            e.at[h].get(mode="promise_in_bounds")
            + w.at[r].get(mode="promise_in_bounds")
            - e.at[t].get(mode="promise_in_bounds")
        )
        if self.norm == 1:
            return jnp.sum(jnp.abs(d), axis=-1)
        return jnp.sqrt(jnp.sum(d * d, axis=-1) + 1e-12)


class RotatE(_KGBase):
    """Entities: (N, 2D) re|im; relations: (R, D) PHASES."""

    def __init__(
        self, kg, seed: int = 0, margin: float = 6.0,
        adversarial_temp: float = 1.0,
    ):
        super().__init__(kg, seed, margin)
        self.adversarial_temp = adversarial_temp

    def _init_state(self, key):
        k1, k2 = jax.random.split(key)
        dim = self.dim
        ent = _uniform_init(k1, self.kg.n_entities, 2 * dim, 6.0 / np.sqrt(dim))
        # unit-sphere init keeps distances O(1) relative to the margin
        ent = ent / jnp.maximum(jnp.linalg.norm(ent, axis=1, keepdims=True), 1e-12)
        phase = jax.random.uniform(
            k2, (self.kg.n_relations, dim), minval=0.0, maxval=2 * np.pi
        )
        return {"entity": ent, "relation": phase}

    def _score(self, state, h, r, t):
        dim = self.dim
        e, ph = state["entity"], state["relation"]
        he = e.at[h].get(mode="promise_in_bounds")
        te = e.at[t].get(mode="promise_in_bounds")
        hr, hi = he[:, :dim], he[:, dim:]
        tr, ti = te[:, :dim], te[:, dim:]
        p = ph.at[r].get(mode="promise_in_bounds")
        cr, ci = jnp.cos(p), jnp.sin(p)
        dr = hr * cr - hi * ci - tr
        di = hr * ci + hi * cr - ti
        return jnp.sqrt(jnp.sum(dr * dr + di * di, axis=-1) + 1e-12)

    def _update_score(self, state, h, r, t):
        """Sum of PER-COORDINATE complex moduli: its gradient is
        diff_d / |diff_d| per coordinate -- the reference's normalized
        step (rotate.go:231-249 divides each coordinate's gradient by
        its own modulus), ~sqrt(dim) larger steps than the plain L2
        score gradient at matched alpha. The margin test still uses the
        L2 _score."""
        dim = self.dim
        e, ph = state["entity"], state["relation"]
        he = e.at[h].get(mode="promise_in_bounds")
        te = e.at[t].get(mode="promise_in_bounds")
        hr, hi = he[:, :dim], he[:, dim:]
        tr, ti = te[:, :dim], te[:, dim:]
        p = ph.at[r].get(mode="promise_in_bounds")
        cr, ci = jnp.cos(p), jnp.sin(p)
        dr = hr * cr - hi * ci - tr
        di = hr * ci + hi * cr - ti
        return jnp.sum(jnp.sqrt(dr * dr + di * di + 1e-12), axis=-1)

    def _adversarial_weight(self, neg_score):
        if self.adversarial_temp <= 0:
            return None
        return jnp.exp(-neg_score / self.adversarial_temp)

    def _renorm(self, state):
        # relations are phases -- unit modulus by construction; entities
        # are NOT normalized in the reference RotatE
        return state

    def _relation_out(self):
        """Export as interleaved cos|sin like a complex row."""
        p = self.state["relation"]
        return jnp.concatenate([jnp.cos(p), jnp.sin(p)], axis=1)


class ComplEx(_KGBase):
    """Entities/relations: (., 2D) re|im; score Re<h, r, conj(t)>."""

    _higher_is_better = True

    def __init__(self, kg, seed: int = 0, margin: float = 1.0):
        super().__init__(kg, seed, margin)

    def _init_state(self, key):
        k1, k2 = jax.random.split(key)
        dim = self.dim
        s = 6.0 / np.sqrt(dim)
        ent = _uniform_init(k1, self.kg.n_entities, 2 * dim, s)
        rel = _uniform_init(k2, self.kg.n_relations, 2 * dim, s)
        ent = ent / jnp.maximum(jnp.linalg.norm(ent, axis=1, keepdims=True), 1e-12)
        return {"entity": ent, "relation": rel}

    def _score(self, state, h, r, t):
        dim = self.dim
        e, w = state["entity"], state["relation"]
        he = e.at[h].get(mode="promise_in_bounds")
        te = e.at[t].get(mode="promise_in_bounds")
        re_ = w.at[r].get(mode="promise_in_bounds")
        hr, hi = he[:, :dim], he[:, dim:]
        tr, ti = te[:, :dim], te[:, dim:]
        rr, ri = re_[:, :dim], re_[:, dim:]
        # Re<h, r, conj(t)> = sum hr*rr*tr + hi*rr*ti + hr*ri*ti - hi*ri*tr
        return jnp.sum(
            hr * rr * tr + hi * rr * ti + hr * ri * ti - hi * ri * tr,
            axis=-1,
        )
