"""Community / CBOW / choice-family update kernels.

Covers the reference kernels that aggregate multiple rows per sample:
  - UpdateCBOW (proNet.cpp:2868-3003): neighbor-SUM CBOW used by GCN and
    TextGCN (the /= num average is commented out in the reference, so the
    aggregation really is a sum).
  - UpdateDChoice (proNet.cpp:2221-2406, live branch): ECO's softmax
    choice over {1-hop context (weight 2), 3-hop context (weight 1),
    negatives}.
  - UpdateFieldCommunity (proNet.cpp:3181-3259): FINE's field-projected
    SGNS along a context walk (shadow row = vid * n_fields + fid).
  - UpdateMSFieldCommunity (proNet.cpp:3261-3308): msFINE's variant --
    vertex side projected, context side plain, reg=0.025.

All kernels are batched: B samples per call, fixed shapes, masks for
dead-end walk truncation, scatter-add write-back (collision="sum" matches
hogwild gradient mass; see ops/update.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from smore_tpu.ops.update import scatter_apply


def cbow_step(
    w: jnp.ndarray,  # (N, D) -- the single table UpdateCBOW touches
    vctx: jnp.ndarray,  # (B, S) neighbor draws of the vertex side
    cctx: jnp.ndarray,  # (B, S) neighbor draws of the context side
    neg_sets: jnp.ndarray,  # (B, K, S) random field-matched sets
    alpha: jnp.ndarray,
    reg: float = 0.01,
    mask: Optional[jnp.ndarray] = None,  # (B,)
    collision: str = "sum",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched UpdateCBOW. w_avg = SUM of vctx rows, c_avg = SUM of cctx
    rows; positive sigmoid step on (w_avg . c_avg) updates the cctx rows
    immediately-in-reference (here: same-batch scatter); each of K
    negative sets plays the context role with label 0; vctx rows receive
    the accumulated vertex-side error."""
    B, S = vctx.shape
    K = neg_sets.shape[1]
    m1 = 1.0 if mask is None else mask[:, None]

    wa = jnp.sum(w.at[vctx].get(mode="promise_in_bounds"), axis=1)  # (B,D)
    ca = jnp.sum(w.at[cctx].get(mode="promise_in_bounds"), axis=1)  # (B,D)
    na = jnp.sum(
        w.at[neg_sets].get(mode="promise_in_bounds"), axis=2
    )  # (B,K,D)

    f_pos = jnp.einsum("bd,bd->b", wa, ca)
    g_pos = (1.0 - jax.nn.sigmoid(f_pos))  # label 1, NOT yet alpha-scaled
    f_neg = jnp.einsum("bd,bkd->bk", wa, na)
    g_neg = -jax.nn.sigmoid(f_neg)
    if mask is not None:
        g_pos = g_pos * mask
        g_neg = g_neg * mask[:, None]

    # vertex-side error: alpha * (g*c_avg - reg*w_avg) per Opt call
    d_w = alpha * (
        g_pos[:, None] * ca
        + jnp.einsum("bk,bkd->bd", g_neg, na)
        - reg * (1 + K) * wa * m1
    )
    # context-side errors (applied to each member of the set)
    d_c = alpha * (g_pos[:, None] * wa - reg * ca * m1)  # (B, D)
    m2 = 1.0 if mask is None else mask[:, None, None]
    d_n = alpha * (g_neg[:, :, None] * wa[:, None, :] - reg * na * m2)  # (B,K,D)

    rep = lambda x, s: jnp.broadcast_to(x[:, None, :], (B, s, x.shape[-1]))
    mask_s = None if mask is None else jnp.repeat(mask, S)
    mask_ks = None if mask is None else jnp.repeat(mask, K * S)
    w = scatter_apply(
        w,
        [
            (vctx.reshape(-1), rep(d_w, S).reshape(B * S, -1), mask_s),
            (cctx.reshape(-1), rep(d_c, S).reshape(B * S, -1), mask_s),
            (
                neg_sets.reshape(-1),
                jnp.broadcast_to(
                    d_n[:, :, None, :], (B, K, S, d_n.shape[-1])
                ).reshape(B * K * S, -1),
                mask_ks,
            ),
        ],
        collision,
    )
    eps = 1e-7
    loss = -jnp.log(jax.nn.sigmoid(f_pos) + eps).mean() - jnp.log(
        1 - jax.nn.sigmoid(f_neg) + eps
    ).sum(-1).mean()
    return w, loss


def dchoice_step(
    w: jnp.ndarray,
    vertex: jnp.ndarray,  # (B,)
    c1: jnp.ndarray,  # (B,) 1-hop context
    c2: jnp.ndarray,  # (B,) 3-hop context
    negs: jnp.ndarray,  # (B, K)
    alpha: jnp.ndarray,
    reg: float = 0.01,
    collision: str = "sum",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched UpdateDChoice (ECO): softmax over {c1 (x2), c2, negs}."""
    v = w.at[vertex].get(mode="promise_in_bounds")
    w1 = w.at[c1].get(mode="promise_in_bounds")
    w2 = w.at[c2].get(mode="promise_in_bounds")
    wn = w.at[negs].get(mode="promise_in_bounds")  # (B,K,D)

    e1 = jnp.exp(jnp.einsum("bd,bd->b", v, w1))
    e2 = jnp.exp(jnp.einsum("bd,bd->b", v, w2))
    en = jnp.exp(jnp.einsum("bd,bkd->bk", v, wn))
    z_pos = 2.0 * e1 + e2
    z = e1 + e2 + en.sum(-1)

    dev = (
        w1 * e1[:, None]
        + w2 * e2[:, None]
        + jnp.einsum("bk,bkd->bd", en, wn)
    )
    d_v = alpha * (
        (2.0 * w1 * e1[:, None] + w2 * e2[:, None]) / z_pos[:, None]
        - dev / z[:, None]
        - reg * v
    )
    d_c1 = alpha * (
        (2.0 * v * e1[:, None]) / z_pos[:, None]
        - (v * e1[:, None]) / z[:, None]
        - reg * w1
    )
    d_c2 = alpha * (
        (v * e2[:, None]) / z_pos[:, None]
        - (v * e2[:, None]) / z[:, None]
        - reg * w2
    )
    d_n = -alpha * (
        v[:, None, :] * en[..., None] / z[:, None, None] + reg * wn
    )

    B, K, D = d_n.shape
    w = scatter_apply(
        w,
        [
            (vertex, d_v),
            (c1, d_c1),
            (c2, d_c2),
            (negs.reshape(-1), d_n.reshape(B * K, D)),
        ],
        collision,
    )
    loss = -jnp.log(jnp.clip(z_pos / (2.0 * z), 1e-9, None)).mean()
    return w, loss


def choice_softmax_step(
    w: jnp.ndarray,  # (N, D) single table (reference passes w_vertex twice)
    vertex: jnp.ndarray,  # (B,)
    pos: jnp.ndarray,  # (B,)
    negs: jnp.ndarray,  # (B, K)
    alpha: jnp.ndarray,
    reg: float = 0.01,
    mask: Optional[jnp.ndarray] = None,
    collision: str = "sum",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched single-table sampled-softmax choice update.

    Covers UpdateHOPChoice (proNet.cpp:2134-2219, live branch: 1 round,
    uniform negatives) and UpdateRecallRank (proNet.cpp:1887-2036: 5
    rounds per call with pos = TargetSample(vertex) and field-matched
    negatives -- rounds/sampling are the caller's job here). Z = exp(pos)
    + sum exp(negs); u gets the deferred softmax gradient, pos/negs update
    immediately (same-batch scatter), all rows L2-shrink by reg.

    Note the reference's RecallRank accumulates a growing pos_scores list
    across rounds and mixes raw/exp'd scores (proNet.cpp:1904-1954) --
    an accumulation bug; this implements the evident per-round intent,
    which is exactly the HOPChoice formula.
    """
    u = w.at[vertex].get(mode="promise_in_bounds")  # (B,D)
    c = w.at[pos].get(mode="promise_in_bounds")
    n = w.at[negs].get(mode="promise_in_bounds")  # (B,K,D)

    e_pos = jnp.exp(jnp.einsum("bd,bd->b", u, c))
    e_neg = jnp.exp(jnp.einsum("bd,bkd->bk", u, n))
    z = e_pos + e_neg.sum(-1)

    dev = c * e_pos[:, None] + jnp.einsum("bk,bkd->bd", e_neg, n)
    m1 = 1.0 if mask is None else mask[:, None]
    d_u = alpha * (c - dev / z[:, None] - reg * u) * m1
    d_c = alpha * (u - u * (e_pos / z)[:, None] - reg * c) * m1
    d_n = -alpha * (
        u[:, None, :] * (e_neg / z[:, None])[..., None] + reg * n
    ) * (1.0 if mask is None else mask[:, None, None])

    B, K, D = d_n.shape
    mask_k = None if mask is None else jnp.repeat(mask, K)
    w = scatter_apply(
        w,
        [
            (vertex, d_u, mask),
            (pos, d_c, mask),
            (negs.reshape(-1), d_n.reshape(B * K, D), mask_k),
        ],
        collision,
    )
    ce = -jnp.log(jnp.clip(e_pos / z, 1e-9, None))
    if mask is None:
        loss = ce.mean()
    else:
        loss = (ce * mask).sum() / jnp.maximum(mask.sum(), 1.0)
    return w, loss


# Alias for inventory parity: UpdateRecallRank is choice_softmax_step with
# 5 rounds of (pos=TargetSample(vertex), field-matched negatives) per
# logical sample -- the ECO-family models expand rounds into the batch.
recall_rank_step = choice_softmax_step
hop_choice_step = choice_softmax_step


def raw_choice_step(
    w_vertex: jnp.ndarray,
    w_context: jnp.ndarray,
    vertex: jnp.ndarray,  # (B,)
    pos: jnp.ndarray,  # (B,)
    negs: jnp.ndarray,  # (B, K)
    alpha: jnp.ndarray,
    reg: float = 0.01,
    mask: Optional[jnp.ndarray] = None,
    collision: str = "sum",
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Batched UpdateRAWChoice (proNet.cpp:2038-2132, live branch):
    "raw" choice scores are sigmoid(-f) instead of exp(f). Faithful to
    the reference's written updates:
      d_u    = alpha*(c*s_pos - (c*s_pos + sum_k n_k*s_k) - reg*u)
      d_pos  = alpha*(u*s_pos - u*Z - reg*c)         [Z = s_pos + sum s_k]
      d_negk = -alpha*(u*Z + reg*n_k)                [scalar Z, as written]
    """
    u = w_vertex.at[vertex].get(mode="promise_in_bounds")
    c = w_context.at[pos].get(mode="promise_in_bounds")
    n = w_context.at[negs].get(mode="promise_in_bounds")

    s_pos = jax.nn.sigmoid(-jnp.einsum("bd,bd->b", u, c))
    s_neg = jax.nn.sigmoid(-jnp.einsum("bd,bkd->bk", u, n))
    z = s_pos + s_neg.sum(-1)

    dev = c * s_pos[:, None] + jnp.einsum("bk,bkd->bd", s_neg, n)
    m1 = 1.0 if mask is None else mask[:, None]
    d_u = alpha * (c * s_pos[:, None] - dev - reg * u) * m1
    d_c = alpha * (u * s_pos[:, None] - u * z[:, None] - reg * c) * m1
    d_n = -alpha * (u[:, None, :] * z[:, None, None] + reg * n) * (
        1.0 if mask is None else mask[:, None, None]
    )

    B, K, D = d_n.shape
    mask_k = None if mask is None else jnp.repeat(mask, K)
    w_context = scatter_apply(
        w_context,
        [(pos, d_c, mask), (negs.reshape(-1), d_n.reshape(B * K, D), mask_k)],
        collision,
    )
    w_vertex = scatter_apply(w_vertex, [(vertex, d_u, mask)], collision)
    ce = -jnp.log(jnp.clip(s_pos / jnp.maximum(z, 1e-9), 1e-9, None))
    if mask is None:
        loss = ce.mean()
    else:
        loss = (ce * mask).sum() / jnp.maximum(mask.sum(), 1.0)
    return w_vertex, w_context, loss


def choice_step(
    w_vertex: jnp.ndarray,  # (N, D)
    w_ignore: jnp.ndarray,  # (N, D) second table ("ignore"/context bank)
    vertex: jnp.ndarray,  # (B,)
    pos2: jnp.ndarray,  # (B,) phase-2 positive (TargetSample(vertex))
    negs1: jnp.ndarray,  # (B, R1, K) phase-1 negatives (5 rounds of K)
    negs2: jnp.ndarray,  # (B, K2) phase-2 negatives (K-1 in the reference)
    alpha: jnp.ndarray,
    reg: float = 0.01,
    collision: str = "sum",
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Batched UpdateChoice (proNet.cpp:2408-2589).

    Phase 1 (x R1 rounds): softmax between the vertex's OWN row in the
    ignore table (positive) and K negatives from the vertex table; the
    vertex-side error is accumulated but never applied in phase 1 (the
    apply is commented out at the reference) -- it carries into the final
    write after phase 2. Phase 2 (x1): softmax with pos2 as positive and
    {negs2, ignore-row} as negatives.
    """
    u = w_vertex.at[vertex].get(mode="promise_in_bounds")  # (B,D)
    ig = w_ignore.at[vertex].get(mode="promise_in_bounds")  # (B,D)
    B, R1, K = negs1.shape
    D = u.shape[-1]

    # ---- phase 1 (vectorized over rounds; all against the snapshot) ----
    n1 = w_vertex.at[negs1].get(mode="promise_in_bounds")  # (B,R1,K,D)
    e_pos1 = jnp.exp(jnp.einsum("bd,bd->b", u, ig))  # (B,)
    e_neg1 = jnp.exp(jnp.einsum("bd,brkd->brk", u, n1))
    z1 = e_pos1[:, None] + e_neg1.sum(-1)  # (B,R1)

    dev1 = ig[:, None, :] * e_pos1[:, None, None] + jnp.einsum(
        "brk,brkd->brd", e_neg1, n1
    )
    back_v = (alpha * (ig[:, None, :] - dev1 / z1[..., None] - reg * u[:, None, :])).sum(1)
    d_ig = alpha * (
        u * R1 - u * (e_pos1[:, None] / z1).sum(-1)[:, None] - reg * ig * R1
    )
    d_n1 = -alpha * (
        u[:, None, None, :] * (e_neg1 / z1[..., None])[..., None] + reg * n1
    )

    # ---- phase 2 ----
    c2 = w_vertex.at[pos2].get(mode="promise_in_bounds")
    n2 = w_vertex.at[negs2].get(mode="promise_in_bounds")  # (B,K2,D)
    e_pos2 = jnp.exp(jnp.einsum("bd,bd->b", u, c2))
    e_neg2 = jnp.exp(jnp.einsum("bd,bkd->bk", u, n2))
    e_ig2 = jnp.exp(jnp.einsum("bd,bd->b", u, ig))
    z2 = e_pos2 + e_neg2.sum(-1) + e_ig2

    dev2 = (
        c2 * e_pos2[:, None]
        + jnp.einsum("bk,bkd->bd", e_neg2, n2)
        + ig * e_ig2[:, None]
    )
    back_v = back_v + alpha * (c2 - dev2 / z2[:, None] - reg * u)
    d_c2 = alpha * (u - u * (e_pos2 / z2)[:, None] - reg * c2)
    d_n2 = -alpha * (u[:, None, :] * (e_neg2 / z2[:, None])[..., None] + reg * n2)
    d_ig = d_ig - alpha * (u * (e_ig2 / z2)[:, None] + reg * ig)

    K2 = negs2.shape[1]
    w_vertex = scatter_apply(
        w_vertex,
        [
            (vertex, back_v),
            (pos2, d_c2),
            (negs1.reshape(-1), d_n1.reshape(B * R1 * K, D)),
            (negs2.reshape(-1), d_n2.reshape(B * K2, D)),
        ],
        collision,
    )
    w_ignore = scatter_apply(w_ignore, [(vertex, d_ig)], collision)
    loss = -jnp.log(jnp.clip(e_pos2 / z2, 1e-9, None)).mean()
    return w_vertex, w_ignore, loss


def field_project(vids: jnp.ndarray, fids: jnp.ndarray, n_fields: int):
    """Shadow row index for (vertex, field): vid * n_fields + fid.
    The reference materializes these as MAX_fvid extra rows
    (proNet.cpp:389-406); here it's pure index arithmetic."""
    return vids * n_fields + fids


def field_community_step(
    w_vertex: jnp.ndarray,  # (N * F, D) shadow vertex table
    w_context: jnp.ndarray,  # (N * F, D) shadow context table
    vertex: jnp.ndarray,  # (B,) plain vids
    ctx_walk: jnp.ndarray,  # (B, S) plain context walk (pos + extensions)
    walk_mask: jnp.ndarray,  # (B, S)
    negs: jnp.ndarray,  # (B, S, K) plain negative vids, field-matched to ctx
    fields_of: jnp.ndarray,  # (N,) field id per vertex
    n_fields: int,
    alpha: jnp.ndarray,
    reg: float = 0.0,
    ms_variant: bool = False,  # msFINE: plain context rows + reg 0.025
    collision: str = "sum",
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Batched UpdateFieldCommunity / UpdateMSFieldCommunity."""
    B, S = ctx_walk.shape
    K = negs.shape[2]
    v_fid = fields_of.at[vertex].get(mode="promise_in_bounds")  # (B,)
    c_fid = fields_of.at[ctx_walk].get(mode="promise_in_bounds")  # (B,S)

    # vertex row projected by the CONTEXT's field, per walk position
    v_rows = field_project(vertex[:, None], c_fid, n_fields)  # (B,S)
    if ms_variant:
        # msFINE uses the PLAIN context row; in the reference's shadow
        # scheme field[vid].vids[own_field] == vid, so the plain row is
        # the own-field projection under the vid*F+fid layout.
        c_rows = field_project(ctx_walk, c_fid, n_fields)
        n_fid = fields_of.at[negs].get(mode="promise_in_bounds")
        n_rows = field_project(negs, n_fid, n_fields)
        reg = 0.025
    else:
        # context row projected by the VERTEX's field
        c_rows = field_project(ctx_walk, v_fid[:, None], n_fields)
        n_rows = field_project(negs, v_fid[:, None, None], n_fields)

    v = w_vertex.at[v_rows].get(mode="promise_in_bounds")  # (B,S,D)
    c = w_context.at[c_rows].get(mode="promise_in_bounds")  # (B,S,D)
    n = w_context.at[n_rows].get(mode="promise_in_bounds")  # (B,S,K,D)

    g_pos = (1.0 - jax.nn.sigmoid(jnp.einsum("bsd,bsd->bs", v, c)))
    g_neg = -jax.nn.sigmoid(jnp.einsum("bsd,bskd->bsk", v, n))
    g_pos = g_pos * walk_mask
    g_neg = g_neg * walk_mask[..., None]

    m2 = walk_mask[..., None]
    d_v = alpha * (
        g_pos[..., None] * c
        + jnp.einsum("bsk,bskd->bsd", g_neg, n)
        - reg * (1 + K) * v * m2
    )
    d_c = alpha * (g_pos[..., None] * v - reg * c * m2)
    d_n = alpha * (g_neg[..., None] * v[:, :, None, :] - reg * n * m2[..., None])

    D = d_v.shape[-1]
    mask_s = walk_mask.reshape(-1)
    mask_sk = jnp.repeat(mask_s, K)
    w_context = scatter_apply(
        w_context,
        [
            (c_rows.reshape(-1), d_c.reshape(B * S, D), mask_s),
            (n_rows.reshape(-1), d_n.reshape(B * S * K, D), mask_sk),
        ],
        collision,
    )
    w_vertex = scatter_apply(
        w_vertex, [(v_rows.reshape(-1), d_v.reshape(B * S, D), mask_s)],
        collision,
    )
    denom = jnp.maximum(walk_mask.sum(), 1.0)
    loss = jnp.sum(-jnp.log(jax.nn.sigmoid(
        jnp.einsum("bsd,bsd->bs", v, c)) + 1e-7) * walk_mask) / denom
    return w_vertex, w_context, loss


# UpdateFieldsCommunity (proNet.cpp:3310-3371) iterates the cross product
# of the vertex's fields x the context's fields; with one field per vertex
# (what LoadFieldMeta produces, proNet.cpp:330-408) the cross product has
# exactly one combination -- vertex row projected by the context's field,
# context row projected by the vertex's field, field-matched negatives --
# which is precisely field_community_step's non-ms branch.
fields_community_step = field_community_step


# ===================================================================== #
# Shared-pool variants (round 5): the shared-pool lever that took the rec
# family to 14-20x. The community kernels' per-sample cost is row-op
# bound -- CBOW touches 2S + K*S rows per sample (70 at the defaults),
# DChoice 3 + K -- so replacing per-sample negatives with one Kp-row
# pool scored against the whole batch as one matmul removes the dominant
# K-term. For the SIGMOID kernels (cbow) the transform is exactly
# expectation-preserving (the gradient is additive in negative sets,
# scaled k_equiv/Kp -- same argument as LINE's shared pool); for the
# SOFTMAX kernels (dchoice/hop_choice) the partition sum z becomes a
# Kp-draw estimate scaled k_equiv/Kp -- a lower-variance estimator of
# the same expectation target, a documented deviation quality-gated on
# the zoo harness (AUC/recall parity at matched budgets).
# ===================================================================== #
def cbow_step_shared_negs(
    w: jnp.ndarray,  # (N, D)
    vctx: jnp.ndarray,  # (B, S)
    cctx: jnp.ndarray,  # (B, S)
    neg_pool: jnp.ndarray,  # (Kp, S) shared random field-matched sets
    alpha: jnp.ndarray,
    k_equiv: int = 5,
    reg: float = 0.01,
    mask: Optional[jnp.ndarray] = None,  # (B,)
    collision: str = "sum",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """cbow_step with ONE pool of Kp negative sets shared across the
    batch. Per-sample gradient in cbow_step is a SUM over its K
    negative sets, so scoring the pool with weight k_equiv/Kp
    preserves the per-sample expected update exactly."""
    B, S = vctx.shape
    Kp = neg_pool.shape[0]
    scale = k_equiv / Kp
    m1 = 1.0 if mask is None else mask[:, None]

    wa = jnp.sum(w.at[vctx].get(mode="promise_in_bounds"), axis=1)
    ca = jnp.sum(w.at[cctx].get(mode="promise_in_bounds"), axis=1)
    na = jnp.sum(
        w.at[neg_pool].get(mode="promise_in_bounds"), axis=1
    )  # (Kp, D)

    f_pos = jnp.einsum("bd,bd->b", wa, ca)
    g_pos = 1.0 - jax.nn.sigmoid(f_pos)
    f_neg = wa @ na.T  # (B, Kp) as one matmul
    g_neg = -jax.nn.sigmoid(f_neg) * scale
    if mask is not None:
        g_pos = g_pos * mask
        g_neg = g_neg * mask[:, None]

    d_w = alpha * (
        g_pos[:, None] * ca + g_neg @ na - reg * (1 + k_equiv) * wa * m1
    )
    d_c = alpha * (g_pos[:, None] * wa - reg * ca * m1)
    # pool-side: per (sample, set) instance alpha*(g*wa - reg*na),
    # accumulated over the batch at the pool scale
    n_inst = (jnp.float32(B) if mask is None else mask.sum()) * scale
    d_n = alpha * (g_neg.T @ wa - reg * n_inst * na)  # (Kp, D)

    rep = lambda x, s: jnp.broadcast_to(x[:, None, :], (x.shape[0], s, x.shape[-1]))
    mask_s = None if mask is None else jnp.repeat(mask, S)
    w = scatter_apply(
        w,
        [
            (vctx.reshape(-1), rep(d_w, S).reshape(B * S, -1), mask_s),
            (cctx.reshape(-1), rep(d_c, S).reshape(B * S, -1), mask_s),
            (neg_pool.reshape(-1), rep(d_n, S).reshape(Kp * S, -1), None),
        ],
        collision,
    )
    eps = 1e-7
    loss = -jnp.log(jax.nn.sigmoid(f_pos) + eps).mean() - (
        k_equiv / Kp
    ) * jnp.log(1 - jax.nn.sigmoid(f_neg) + eps).sum(-1).mean()
    return w, loss


def dchoice_step_shared_negs(
    w: jnp.ndarray,
    vertex: jnp.ndarray,  # (B,)
    c1: jnp.ndarray,  # (B,)
    c2: jnp.ndarray,  # (B,)
    neg_pool: jnp.ndarray,  # (Kp,) shared negatives
    alpha: jnp.ndarray,
    k_equiv: int = 5,
    reg: float = 0.01,
    collision: str = "sum",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """dchoice_step with a shared negative pool: z's negative mass is
    the pool sum scaled k_equiv/Kp (sampled-softmax estimator)."""
    Kp = neg_pool.shape[0]
    scale = k_equiv / Kp
    v = w.at[vertex].get(mode="promise_in_bounds")
    w1 = w.at[c1].get(mode="promise_in_bounds")
    w2 = w.at[c2].get(mode="promise_in_bounds")
    wn = w.at[neg_pool].get(mode="promise_in_bounds")  # (Kp, D)

    e1 = jnp.exp(jnp.einsum("bd,bd->b", v, w1))
    e2 = jnp.exp(jnp.einsum("bd,bd->b", v, w2))
    en = jnp.exp(v @ wn.T)  # (B, Kp)
    z_pos = 2.0 * e1 + e2
    z = e1 + e2 + scale * en.sum(-1)

    dev = (
        w1 * e1[:, None]
        + w2 * e2[:, None]
        + scale * (en @ wn)
    )
    d_v = alpha * (
        (2.0 * w1 * e1[:, None] + w2 * e2[:, None]) / z_pos[:, None]
        - dev / z[:, None]
        - reg * v
    )
    d_c1 = alpha * (
        (2.0 * v * e1[:, None]) / z_pos[:, None]
        - (v * e1[:, None]) / z[:, None]
        - reg * w1
    )
    d_c2 = alpha * (
        (v * e2[:, None]) / z_pos[:, None]
        - (v * e2[:, None]) / z[:, None]
        - reg * w2
    )
    B = v.shape[0]
    wz = en / z[:, None]  # (B, Kp)
    d_n = -alpha * scale * (wz.T @ v + reg * B * wn)

    w = scatter_apply(
        w,
        [(vertex, d_v), (c1, d_c1), (c2, d_c2), (neg_pool, d_n)],
        collision,
    )
    loss = -jnp.log(jnp.clip(z_pos / (2.0 * z), 1e-9, None)).mean()
    return w, loss


def choice_softmax_step_shared_negs(
    w: jnp.ndarray,
    vertex: jnp.ndarray,  # (B,)
    pos: jnp.ndarray,  # (B,)
    neg_pool: jnp.ndarray,  # (Kp,) shared negatives
    alpha: jnp.ndarray,
    k_equiv: int = 5,
    reg: float = 0.01,
    mask: Optional[jnp.ndarray] = None,
    collision: str = "sum",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """choice_softmax_step (UpdateHOPChoice) with a shared pool."""
    Kp = neg_pool.shape[0]
    scale = k_equiv / Kp
    u = w.at[vertex].get(mode="promise_in_bounds")
    c = w.at[pos].get(mode="promise_in_bounds")
    n = w.at[neg_pool].get(mode="promise_in_bounds")  # (Kp, D)

    e_pos = jnp.exp(jnp.einsum("bd,bd->b", u, c))
    e_neg = jnp.exp(u @ n.T)  # (B, Kp)
    z = e_pos + scale * e_neg.sum(-1)

    dev = c * e_pos[:, None] + scale * (e_neg @ n)
    m1 = 1.0 if mask is None else mask[:, None]
    d_u = alpha * (c - dev / z[:, None] - reg * u) * m1
    d_c = alpha * (u - u * (e_pos / z)[:, None] - reg * c) * m1
    B = u.shape[0]
    wz = e_neg / z[:, None]
    if mask is not None:
        wz = wz * mask[:, None]
    n_inst = (jnp.float32(B) if mask is None else mask.sum())
    d_n = -alpha * scale * (wz.T @ u + reg * n_inst * n)

    w = scatter_apply(
        w,
        [(vertex, d_u, mask), (pos, d_c, mask), (neg_pool, d_n)],
        collision,
    )
    ce = -jnp.log(jnp.clip(e_pos / z, 1e-9, None))
    if mask is None:
        loss = ce.mean()
    else:
        loss = (ce * mask).sum() / jnp.maximum(mask.sum(), 1.0)
    return w, loss


def field_community_step_shared_negs(
    w_vertex: jnp.ndarray,  # (N * F, D) shadow vertex table
    w_context: jnp.ndarray,  # (N * F, D) shadow context table
    vertex: jnp.ndarray,  # (B,) plain vids
    ctx_walk: jnp.ndarray,  # (B, S) plain context walk
    walk_mask: jnp.ndarray,  # (B, S)
    neg_pool: jnp.ndarray,  # (F, Kp) plain negative vids, pool f drawn
    # from field f's negative law (the field-matched rejection loop,
    # proNet.cpp:3209-3212, as one pool per field)
    fields_of: jnp.ndarray,  # (N,)
    n_fields: int,
    alpha: jnp.ndarray,
    k_equiv: int = 5,
    reg: float = 0.0,
    ms_variant: bool = False,
    collision: str = "sum",
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """field_community_step with per-field shared negative pools.

    Each (sample, walk position) scores field c_fid's pool, projected
    by the vertex's field (non-ms) or the negative's own field (ms) --
    so the pool lives as (F_draw, F_proj, Kp) projected shadow rows,
    gathered ONCE per step instead of B*S*K per-sample rows (the
    dominant row-op term: 70% of the kernel's rows at K=5). The
    sigmoid gradient is additive in negatives, so k_equiv/Kp scaling
    preserves the per-sample expected update exactly; selection is by
    one-hot field masks as one matmul, not gathers."""
    B, S = ctx_walk.shape
    F, Kp = neg_pool.shape
    scale = k_equiv / Kp
    v_fid = fields_of.at[vertex].get(mode="promise_in_bounds")  # (B,)
    c_fid = fields_of.at[ctx_walk].get(mode="promise_in_bounds")  # (B,S)

    v_rows = field_project(vertex[:, None], c_fid, n_fields)
    if ms_variant:
        reg = 0.025  # msFINE override, as in field_community_step
        c_rows = field_project(ctx_walk, c_fid, n_fields)
        # ms: negatives project by their OWN field == their pool's
        # draw field -> only the diagonal (f, f) pool blocks are used
        pool_rows = field_project(
            neg_pool[:, None, :],
            jnp.arange(F, dtype=jnp.int32)[:, None, None], n_fields,
        )  # (F, 1, Kp) -> proj == draw
        pool_rows = jnp.broadcast_to(pool_rows, (F, F, Kp))
    else:
        c_rows = field_project(ctx_walk, v_fid[:, None], n_fields)
        # non-ms: pool f projected by every possible vertex field g
        pool_rows = field_project(
            neg_pool[:, None, :],
            jnp.arange(F, dtype=jnp.int32)[None, :, None], n_fields,
        )  # (F_draw, F_proj, Kp)

    v = w_vertex.at[v_rows].get(mode="promise_in_bounds")  # (B,S,D)
    c = w_context.at[c_rows].get(mode="promise_in_bounds")  # (B,S,D)
    npool = w_context.at[pool_rows].get(
        mode="promise_in_bounds"
    )  # (F,F,Kp,D)

    g_pos = (1.0 - jax.nn.sigmoid(jnp.einsum("bsd,bsd->bs", v, c)))
    g_pos = g_pos * walk_mask

    # one-hot field selection: sample (b,s) uses draw field c_fid[b,s]
    # and projection field v_fid[b] (ms: projection == draw)
    oh_c = jax.nn.one_hot(c_fid, F, dtype=v.dtype)  # (B,S,F)
    oh_v = jax.nn.one_hot(
        c_fid if ms_variant else
        jnp.broadcast_to(v_fid[:, None], (B, S)), F, dtype=v.dtype
    )  # (B,S,F)
    sel = jnp.einsum("bsf,bsg->bsfg", oh_c, oh_v)  # (B,S,F,F)

    f_neg = jnp.einsum("bsd,fgkd->bsfgk", v, npool)
    g_neg = -jax.nn.sigmoid(f_neg) * (
        sel[..., None] * walk_mask[:, :, None, None, None]
    ) * scale  # (B,S,F,F,Kp)

    m2 = walk_mask[..., None]
    d_v = alpha * (
        g_pos[..., None] * c
        + jnp.einsum("bsfgk,fgkd->bsd", g_neg, npool)
        - reg * (1 + k_equiv) * v * m2
    )
    d_c = alpha * (g_pos[..., None] * v - reg * c * m2)
    # exact per-pool instance counts: (b,s) regularizes only ITS
    # (draw, projection) pool block, at the k_equiv/Kp pool scale
    inst = jnp.einsum("bsfg,bs->fg", sel, walk_mask) * scale  # (F,F)
    d_n = alpha * (
        jnp.einsum("bsfgk,bsd->fgkd", g_neg, v)
        - reg * inst[:, :, None, None] * npool
    )

    D = d_v.shape[-1]
    mask_s = walk_mask.reshape(-1)
    w_context = scatter_apply(
        w_context,
        [
            (c_rows.reshape(-1), d_c.reshape(B * S, D), mask_s),
            (pool_rows.reshape(-1), d_n.reshape(F * F * Kp, D)),
        ],
        collision,
    )
    w_vertex = scatter_apply(
        w_vertex, [(v_rows.reshape(-1), d_v.reshape(B * S, D), mask_s)],
        collision,
    )
    denom = jnp.maximum(walk_mask.sum(), 1.0)
    loss = jnp.sum(-jnp.log(jax.nn.sigmoid(
        jnp.einsum("bsd,bsd->bs", v, c)) + 1e-7) * walk_mask) / denom
    return w_vertex, w_context, loss
