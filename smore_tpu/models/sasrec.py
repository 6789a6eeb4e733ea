"""SASRec family: self-attentive sequential recommendation.

Reference: /root/reference/internal/models/{sasrec,gsasrec,recdenoiser}/.
Shared architecture (sasrec.go:96-492): item embedding + SINUSOIDAL
positions (:112-133), num_blocks of pre-LN causal MHA + 4x FFN with
residuals and dropout; sequences = each user's neighbor list in edge
order (:82-93); defaults dim=64, max_seq_len=50, blocks=2, heads=1,
dropout=0.2, epochs=10, batch=128, alpha=0.001 (cmd/sasrec/main.go).

Variants:
  - gSASRec (gsasrec.go:256-275): gBCE loss -- positive CE weighted by
    beta, negative CE by (1-beta).
  - Rec-Denoiser (recdenoiser.go:174-247,317-332): per-block trainable
    L x L attention-mask logits sampled via Gumbel-sigmoid, multiplied
    into the attention weights, with an L1 sparsity penalty.

Upgrade over the reference (SURVEY.md 3.4): the Go code initializes the
transformer but only ever trains the item embeddings (forward-only
attention); here the WHOLE model trains by real autodiff (flax + optax
Adam), while keeping the reference's sequence construction, loss
structure, and save format (item rows, standard text dump).
"""

from __future__ import annotations

from typing import Optional

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax

from smore_tpu.graph.graph import Graph
from smore_tpu.io.embeddings import save_embeddings


def sinusoidal_positions(max_len: int, dim: int) -> np.ndarray:
    """sasrec.go:121-133 exactly (even dims sin, odd dims cos)."""
    pos = np.arange(max_len)[:, None].astype(np.float64)
    d = np.arange(dim)[None, :]
    div = np.power(10000.0, (d - (d % 2)) / dim)
    ang = pos / div
    out = np.where(d % 2 == 0, np.sin(ang), np.cos(ang))
    return out.astype(np.float32)


class _Block(nn.Module):
    dim: int
    heads: int
    dropout: float
    max_len: int
    denoise: bool = False
    mask_temp: float = 1.0

    @nn.compact
    def __call__(self, x, pad_mask, *, train: bool):
        B, L, D = x.shape
        causal = jnp.tril(jnp.ones((L, L), dtype=bool))
        bias = jnp.where(causal, 0.0, -1e9)[None, None, :, :]

        h = nn.LayerNorm()(x)
        q = nn.DenseGeneral((self.heads, D // self.heads), name="q")(h)
        k = nn.DenseGeneral((self.heads, D // self.heads), name="k")(h)
        v = nn.DenseGeneral((self.heads, D // self.heads), name="v")(h)
        logits = jnp.einsum("blhd,bmhd->bhlm", q, k) / np.sqrt(D // self.heads)
        logits = logits + bias
        logits = logits + jnp.where(
            pad_mask[:, None, None, :], 0.0, -1e9
        )
        w = jax.nn.softmax(logits, axis=-1)

        if self.denoise:
            # Rec-Denoiser: trainable mask logits, Gumbel-sigmoid sampled
            # during training, hard sigmoid at eval (recdenoiser.go:174-247)
            mlog = self.param(
                "mask_logits",
                nn.initializers.constant(2.0),  # start ~open (sigmoid~0.88)
                (self.max_len, self.max_len),
            )
            ml = mlog[:L, :L]
            if train:
                rng = self.make_rng("gumbel")
                u = jax.random.uniform(rng, (2,) + ml.shape, minval=1e-6,
                                       maxval=1.0 - 1e-6)
                g = -jnp.log(-jnp.log(u))
                y = (ml + g[0] - g[1]) / self.mask_temp
                mask = jax.nn.sigmoid(y)
            else:
                mask = jax.nn.sigmoid(ml / self.mask_temp)
            w = w * mask[None, None, :, :]
            self.sow("intermediates", "attn_mask", mask)

        w = nn.Dropout(self.dropout, deterministic=not train)(w)
        attn = jnp.einsum("bhlm,bmhd->blhd", w, v)
        attn = nn.DenseGeneral(D, axis=(-2, -1), name="o")(attn)
        x = x + nn.Dropout(self.dropout, deterministic=not train)(attn)

        h = nn.LayerNorm()(x)
        f = nn.Dense(4 * D)(h)
        f = nn.relu(f)
        f = nn.Dense(D)(f)
        x = x + nn.Dropout(self.dropout, deterministic=not train)(f)
        return x


class SASRecNet(nn.Module):
    num_items: int  # real items; id num_items = padding
    dim: int
    max_len: int
    blocks: int = 2
    heads: int = 1
    dropout: float = 0.2
    denoise: bool = False
    mask_temp: float = 1.0

    @nn.compact
    def __call__(self, seq, *, train: bool):
        """seq (B, L) int32 with pad id == num_items. Returns hidden
        states (B, L, D) after the final LayerNorm."""
        emb = nn.Embed(
            self.num_items + 1, self.dim,
            embedding_init=nn.initializers.normal(0.5 / self.dim),
            name="item",
        )
        pad_mask = seq != self.num_items
        x = emb(seq) * pad_mask[..., None]
        x = x + jnp.asarray(sinusoidal_positions(self.max_len, self.dim))[
            None, : seq.shape[1]
        ]
        x = nn.Dropout(self.dropout, deterministic=not train)(x)
        for b in range(self.blocks):
            x = _Block(
                self.dim, self.heads, self.dropout, self.max_len,
                denoise=self.denoise, mask_temp=self.mask_temp,
                name=f"block{b}",
            )(x, pad_mask, train=train)
        x = nn.LayerNorm(name="final_ln")(x)
        return x * pad_mask[..., None]

    def item_table(self, params):
        return params["params"]["item"]["embedding"]


class SASRec:
    """loss='bce' (SASRec) | 'gbce' (gSASRec); denoise=True (Rec-Denoiser)."""

    loss = "bce"
    denoise = False

    def __init__(self, graph: Graph, seed: int = 0, beta: float = 0.5,
                 lambda_sparsity: float = 0.01, negative_samples: int = 1,
                 sparsity: float = 0.3):
        self.graph = graph
        self.seed = seed
        self.beta = beta
        self.lambda_sparsity = lambda_sparsity
        # per-position negatives, SUMMED like the reference's per-negative
        # update loop (sasrec.go:576-593; Go default 1)
        self.neg_k = max(1, int(negative_samples))
        # Go stores a target sparsity rate on the denoiser (recdenoiser.go
        # :81-97) but never consumes it past the banner; kept for surface
        # parity.
        self.sparsity = sparsity
        self.net: Optional[SASRecNet] = None
        self.params = None
        self.dim = 0
        self.max_len = 50

    @classmethod
    def load_edge_list(cls, path: str, **kw):
        # user-item interactions; direction matters (user -> item order)
        return cls(Graph.load_edge_list(path, undirected=False), **kw)

    def build_sequences(self) -> np.ndarray:
        """sasrec.go BuildSequencesFromGraph: each vertex's out-neighbor
        list in edge (file) order IS its sequence; keep the last
        max_len + 1 items; pad id = n_vertices."""
        g = self.graph
        L = self.max_len + 1
        pad = g.n_vertices
        seqs = []
        for u in range(g.n_vertices):
            nb = g.neighbors(u)
            if len(nb) < 2:
                continue
            s = nb[-L:]
            seqs.append(
                np.concatenate(
                    [np.full(L - len(s), pad, dtype=np.int64), s]
                )
            )
        if not seqs:
            raise ValueError("no user has >= 2 interactions")
        return np.stack(seqs).astype(np.int32)

    def init(self, dim: int, max_seq_len: int = 50, num_blocks: int = 2,
             num_heads: int = 1, dropout: float = 0.2) -> None:
        self.dim = dim
        self.max_len = max_seq_len
        self.net = SASRecNet(
            num_items=self.graph.n_vertices,
            dim=dim,
            max_len=max_seq_len,
            blocks=num_blocks,
            heads=num_heads,
            dropout=dropout,
            denoise=self.denoise,
        )
        k = jax.random.PRNGKey(self.seed)
        dummy = jnp.full((1, max_seq_len), self.graph.n_vertices, jnp.int32)
        self.params = self.net.init(
            {"params": k, "dropout": k, "gumbel": k}, dummy, train=False
        )

    def _loss_fn(self, params, batch, key):
        net = self.net
        n = self.graph.n_vertices
        seq, pos = batch[:, :-1], batch[:, 1:]
        kd, kg, kn = jax.random.split(key, 3)
        h = net.apply(
            params, seq, train=True, rngs={"dropout": kd, "gumbel": kg}
        )  # (B, L, D)
        table = net.item_table(params)  # (n+1, D)
        valid = (pos != n) & (seq != n)
        K = self.neg_k
        negs = jax.random.randint(kn, pos.shape + (K,), 0, n)

        s_pos = jnp.einsum(
            "bld,bld->bl", h, table.at[pos].get(mode="promise_in_bounds")
        )
        s_neg = jnp.einsum(
            "bld,blkd->blk", h, table.at[negs].get(mode="promise_in_bounds")
        )
        # negatives are SUMMED, matching the reference's per-negative
        # update loop (sasrec.go:576-593)
        neg_ce = -jax.nn.log_sigmoid(-s_neg).sum(axis=-1)
        if self.loss == "gbce":
            b = self.beta
            ce = -b * jax.nn.log_sigmoid(s_pos) + (1.0 - b) * neg_ce
        else:
            ce = -jax.nn.log_sigmoid(s_pos) + neg_ce
        loss = jnp.sum(ce * valid) / jnp.maximum(valid.sum(), 1)

        if self.denoise:
            # L1 sparsity on the sampled masks (recdenoiser.go:317-332)
            l1 = sum(
                jnp.abs(jax.nn.sigmoid(p["mask_logits"])).mean()
                for k_, p in params["params"].items()
                if k_.startswith("block") and "mask_logits" in p
            )
            loss = loss + self.lambda_sparsity * l1
        return loss

    def train(self, epochs: int = 10, batch_size: int = 128,
              alpha: float = 0.001, verbose: bool = True,
              holdout: bool = False, forward_only: bool = False,
              checkpoint: Optional[str] = None, checkpoint_every: int = 1,
              resume: bool = True) -> None:
        """holdout=True withholds each sequence's LAST item from training
        (standard leave-one-out next-item protocol); evaluate with
        evaluate_ranking() afterwards.

        forward_only=True reproduces the reference's training semantics
        exactly: the transformer (attention/FFN/LN/positions) is used in
        the forward pass but NEVER receives gradients -- only the item
        embedding table trains (sasrec.go:553-593 updates itemEmbed rows
        alone). Default False = full autodiff, the documented upgrade.

        checkpoint: checkpoint dir — the FULL train state (flax
        params, optax adam state, PRNG chain) is saved every
        ``checkpoint_every`` epochs (and at the end); with ``resume`` a
        restart continues the exact uninterrupted trajectory (the
        reference has no mid-train persistence at all, SURVEY.md 5.4)."""
        seqs = self.build_sequences()
        if holdout:
            self._holdout_seqs = seqs
            pad_col = np.full((len(seqs), 1), self.graph.n_vertices,
                              np.int32)
            seqs = np.concatenate([pad_col, seqs[:, :-1]], axis=1)
        n_seq = len(seqs)
        tx = optax.adam(alpha)
        opt_state = tx.init(self.params)
        params = self.params

        if forward_only:
            def keep(path, g):
                names = {getattr(p, "key", None) for p in path}
                return g if "item" in names else jnp.zeros_like(g)
        else:
            def keep(path, g):
                return g

        @jax.jit
        def step(params, opt_state, batch, key):
            loss, grads = jax.value_and_grad(self._loss_fn)(params, batch, key)
            grads = jax.tree_util.tree_map_with_path(keep, grads)
            updates, opt_state = tx.update(grads, opt_state)
            return optax.apply_updates(params, updates), opt_state, loss

        key = jax.random.PRNGKey(self.seed + 7)
        start_ep = 0
        if checkpoint:
            # Optax states are NamedTuple pytrees a dict checkpoint cannot
            # hold structurally; store the flat leaves and unflatten against a
            # freshly built treedef (tx.init of the current params).
            from smore_tpu.utils.checkpoint import (
                checkpoint_exists, load_checkpoint, save_checkpoint)

            treedef = jax.tree.structure((params, opt_state, key))
            if resume and checkpoint_exists(checkpoint):
                flat, done_ep, _ = load_checkpoint(checkpoint)
                leaves = [jnp.asarray(flat[f"{i:04d}"])
                          for i in range(len(flat))]
                params, opt_state, key = jax.tree.unflatten(treedef, leaves)
                start_ep = min(int(done_ep), epochs)

            def _save(ep_done):
                leaves = jax.device_get(
                    jax.tree.leaves((params, opt_state, key)))
                save_checkpoint(
                    checkpoint,
                    {f"{i:04d}": l for i, l in enumerate(leaves)},
                    step=ep_done,
                )

        bs = min(batch_size, n_seq)
        n_batches = max(1, n_seq // bs)
        seqs_d = jnp.asarray(seqs)
        for ep in range(start_ep, epochs):
            key, kp = jax.random.split(key)
            perm = jax.random.permutation(kp, n_seq)[: n_batches * bs]
            perm = perm.reshape(n_batches, bs)
            for b in range(n_batches):
                key, ks = jax.random.split(key)
                batch = seqs_d.at[perm[b]].get(mode="promise_in_bounds")
                params, opt_state, loss = step(params, opt_state, batch, ks)
            if verbose:
                print(f"\tepoch {ep + 1}/{epochs} loss={float(loss):.5f}",
                      end="\r", flush=True)
            if checkpoint and ((ep + 1) % max(1, checkpoint_every)
                               == 0 or ep + 1 == epochs):
                _save(ep + 1)
        if verbose:
            print()
        self.params = params

    # -- inference ------------------------------------------------------ #
    def hidden_states(self, seqs: np.ndarray) -> jnp.ndarray:
        return self.net.apply(self.params, jnp.asarray(seqs), train=False)

    def score_next(self, seqs: np.ndarray) -> jnp.ndarray:
        """Scores over all items for each sequence's next step."""
        h = self.hidden_states(seqs)[:, -1]  # (B, D)
        table = self.net.item_table(self.params)[:-1]  # drop pad row
        return h @ table.T

    def evaluate_ranking(self, ks=(10,), batch_size: int = 256) -> dict:
        """Leave-one-out next-item ranking eval (train(holdout=True) first).

        For each held-out user: input = the sequence minus its last item,
        target = that last item; the target is ranked against ALL items
        (full ranking, no negative sampling -- stricter and deterministic
        vs the sampled-100 protocol common in the literature). Items
        already in the user's input are excluded from the candidate set.
        Returns {"recall@k": ..., "ndcg@k": ...}.
        """
        seqs = getattr(self, "_holdout_seqs", None)
        if seqs is None:
            raise ValueError("call train(holdout=True) before "
                             "evaluate_ranking()")
        pad = self.graph.n_vertices
        # seqs is (B, max_len+1) left-padded; dropping the last column
        # yields the (B, max_len) input ending just before the target.
        prefixes = seqs[:, :-1]
        targets = seqs[:, -1]
        hits = {k: 0.0 for k in ks}
        ndcg = {k: 0.0 for k in ks}
        n = 0
        for i in range(0, len(seqs), batch_size):
            pf = prefixes[i:i + batch_size]
            tg = targets[i:i + batch_size]
            scores = np.array(self.score_next(pf))  # (b, n_items), writable
            # mask items already seen in the prefix
            rows = np.repeat(np.arange(len(pf)), pf.shape[1])
            cols = pf.reshape(-1)
            keep = cols < pad
            scores[rows[keep], cols[keep]] = -np.inf
            t_scores = scores[np.arange(len(pf)), tg]
            rank = (scores > t_scores[:, None]).sum(axis=1)  # 0-based
            for k in ks:
                hit = rank < k
                hits[k] += hit.sum()
                ndcg[k] += (hit / np.log2(rank + 2)).sum()
            n += len(pf)
        out = {}
        for k in ks:
            out[f"recall@{k}"] = hits[k] / n
            out[f"ndcg@{k}"] = ndcg[k] / n
        return out

    def save_weights(self, path: str) -> None:
        table = np.asarray(self.net.item_table(self.params))[:-1]
        save_embeddings(path, self.graph.names, table)


class GSASRec(SASRec):
    loss = "gbce"


class RecDenoiser(SASRec):
    denoise = True
