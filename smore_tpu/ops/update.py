"""Fused embedding-update kernels (pure-XLA form).

Every reference SGD primitive (proNet::Opt_* , /root/reference/src/
proNet.cpp:991-1351) and composite kernel (proNet::Update*, proNet.cpp:
1353-3371) is a per-pair scalar loop: dot -> scalar grad -> axpy into two
table rows, applied hogwild from many threads. On the accelerator the
equivalent is a batched, deterministic step:

    gather rows -> batched dot -> loss-specific scalar grad
    -> scaled outer products -> scatter-add back

Within-batch index collisions sum their contributions (the analog of
hogwild races; see SURVEY.md section 7.3). All kernels take an optional
``mask`` so fixed-shape batches can carry invalid slots (padding from walk
mappers), and return a scalar mean loss for monitoring.

Notes on fidelity:
  - the reference's ``fastSigmoid`` is a 1000-bin LUT over [-8, 8] clamped
    to {0,1} outside (proNet.cpp:52-71); the accelerator computes a real
    sigmoid at full rate, so we use the exact function.
  - the reference updates context rows mid-loop and the vertex row at the
    end (deferred ``back_err``); a batch applies everything against the
    batch-start snapshot. Parity is enforced empirically (quality gates),
    not bitwise.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

# Precision of the float32 dots of the banded SGNS step: DEFAULT lets XLA
# run them as TF32 on the H100's tensor cores. HIGHEST is the setting the
# reference comparisons in tests/ and chip_smoke.py also run at.
SGNS_PRECISION = jax.lax.Precision.DEFAULT


def _maybe_mask(g: jnp.ndarray, mask: Optional[jnp.ndarray]) -> jnp.ndarray:
    if mask is None:
        return g
    return g * mask


def scatter_apply(
    w: jnp.ndarray,
    idx_deltas,
    collision: str = "sum",
) -> jnp.ndarray:
    """Apply row updates ``[(idx (B,), delta (B, D)), ...]`` to table ``w``.

    collision="sum" (default): plain scatter-add -- duplicate rows in the
    batch sum their contributions, preserving the reference hogwild's TOTAL
    gradient mass (each of k colliding updates is applied in full, just
    against the batch-start snapshot instead of sequentially,
    proNet.cpp:1784-1809). Measured on the 50k-vertex bench graph this
    exactly matches reference quality (DeepWalk link-AUC 0.9966 vs 0.9958)
    where "mean" loses signal (0.68): dividing by occurrence count throws
    away (k-1)/k of every hub row's gradient.

    collision="mean": each row's accumulated delta is divided by the row's
    total occurrence count across ALL index sets targeting this table.
    Bounded like a single sequential update on hubs -- useful on TINY
    graphs (tests, toy nets) where batch >> n_vertices makes "sum" apply
    hundreds of same-direction stale gradients per row per step and
    diverge. Cost: one (N,) count buffer + one extra gather per index set.

    Entries may be (idx, delta) or (idx, delta, count_w) where count_w
    (B,) weights the occurrence count (pass the batch mask so padded slots
    do not dilute the mean).
    """
    if collision == "sum":
        for entry in idx_deltas:
            idx, delta = entry[0], entry[1]
            w = w.at[idx].add(delta, mode="promise_in_bounds")
        return w
    cnt = jnp.zeros((w.shape[0],), dtype=w.dtype)
    for entry in idx_deltas:
        idx = entry[0]
        cw = entry[2] if len(entry) > 2 and entry[2] is not None else None
        cnt = cnt.at[idx].add(1.0 if cw is None else cw, mode="promise_in_bounds")
    cnt = jnp.maximum(cnt, 1.0)
    for entry in idx_deltas:
        idx, delta = entry[0], entry[1]
        w = w.at[idx].add(delta / cnt.at[idx].get(mode="promise_in_bounds")[:, None], mode="promise_in_bounds")
    return w


def apply_two_tables(
    w_vertex: jnp.ndarray,
    w_context: jnp.ndarray,
    vertex_entries,
    context_entries,
    shared_table: bool = False,
    update_vertex: bool = True,
    collision: str = "sum",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Scatter vertex-side and context-side updates, honoring the
    single-shared-table case (the reference's MF/BPR/WARP/SkewOPT pass
    w_vertex as both tables, e.g. BPR.cpp:92): with shared_table=True all
    entries land in ONE scatter pass so nothing is lost."""
    if shared_table:
        entries = list(context_entries) + (
            list(vertex_entries) if update_vertex else []
        )
        w = scatter_apply(w_vertex, entries, collision)
        return w, w
    w_context = scatter_apply(w_context, context_entries, collision)
    if update_vertex:
        w_vertex = scatter_apply(w_vertex, vertex_entries, collision)
    return w_vertex, w_context


# --------------------------------------------------------------------- #
# SGNS (skip-gram negative sampling) -- the workhorse.
# Reference: UpdatePair (proNet.cpp:1784-1809) built on Opt_SigmoidSGD
# (proNet.cpp:1312-1330).
# --------------------------------------------------------------------- #
def sgns_grads(
    w_vertex: jnp.ndarray,  # (N, D)
    w_context: jnp.ndarray,  # (M, D)
    src: jnp.ndarray,  # (B,) int
    pos: jnp.ndarray,  # (B,) int
    negs: jnp.ndarray,  # (B, K) int
    alpha: jnp.ndarray,  # scalar learning rate
    mask: Optional[jnp.ndarray] = None,  # (B,) 0/1
    reg: float = 0.0,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Compute SGNS deltas. Returns (d_src (B,D), d_pos (B,D),
    d_neg (B,K,D), loss scalar)."""
    v = w_vertex.at[src].get(mode="promise_in_bounds")  # (B, D)
    cp = w_context.at[pos].get(mode="promise_in_bounds")  # (B, D)
    cn = w_context.at[negs].get(mode="promise_in_bounds")  # (B, K, D)

    f_pos = jnp.einsum("bd,bd->b", v, cp)
    f_neg = jnp.einsum("bd,bkd->bk", v, cn)
    s_pos = jax.nn.sigmoid(f_pos)
    s_neg = jax.nn.sigmoid(f_neg)

    g_pos = _maybe_mask((1.0 - s_pos) * alpha, mask)  # label = 1
    g_neg = (0.0 - s_neg) * alpha  # label = 0
    if mask is not None:
        g_neg = g_neg * mask[:, None]

    d_src = g_pos[:, None] * cp + jnp.einsum("bk,bkd->bd", g_neg, cn)
    d_pos = g_pos[:, None] * v
    d_neg = g_neg[:, :, None] * v[:, None, :]
    if reg:
        d_src = d_src - (alpha * reg) * v * (1.0 if mask is None else mask[:, None])
        d_pos = d_pos - (alpha * reg) * cp * (1.0 if mask is None else mask[:, None])

    # Monitoring loss: masked mean binary CE.
    eps = 1e-7
    ce = -jnp.log(s_pos + eps) - jnp.sum(jnp.log(1.0 - s_neg + eps), axis=-1)
    if mask is not None:
        denom = jnp.maximum(mask.sum(), 1.0)
        loss = jnp.sum(ce * mask) / denom
    else:
        loss = jnp.mean(ce)
    return d_src, d_pos, d_neg, loss


def sgns_step(
    w_vertex: jnp.ndarray,
    w_context: jnp.ndarray,
    src: jnp.ndarray,
    pos: jnp.ndarray,
    negs: jnp.ndarray,
    alpha: jnp.ndarray,
    mask: Optional[jnp.ndarray] = None,
    reg: float = 0.0,
    update_vertex: bool = True,
    collision: str = "sum",
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """One SGNS update against distinct vertex/context tables
    (LINE order-2, DeepWalk, ...). ``update_vertex=False`` gives the
    reference's UpdateFreezePair (proNet.cpp:1584)."""
    d_src, d_pos, d_neg, loss = sgns_grads(
        w_vertex, w_context, src, pos, negs, alpha, mask, reg
    )
    B, K, D = d_neg.shape
    mask_k = None if mask is None else jnp.repeat(mask, K)
    w_context = scatter_apply(
        w_context,
        [
            (pos, d_pos, mask),
            (negs.reshape(-1), d_neg.reshape(B * K, D), mask_k),
        ],
        collision,
    )
    if update_vertex:
        w_vertex = scatter_apply(w_vertex, [(src, d_src, mask)], collision)
    return w_vertex, w_context, loss


def sgns_step_shared(
    w: jnp.ndarray,
    src: jnp.ndarray,
    pos: jnp.ndarray,
    negs: jnp.ndarray,
    alpha: jnp.ndarray,
    mask: Optional[jnp.ndarray] = None,
    reg: float = 0.0,
    collision: str = "sum",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """SGNS with a single shared table (LINE order-1: both endpoints live
    in the same table, /root/reference/src/model/LINE.cpp order=1 path)."""
    d_src, d_pos, d_neg, loss = sgns_grads(w, w, src, pos, negs, alpha, mask, reg)
    B, K, D = d_neg.shape
    mask_k = None if mask is None else jnp.repeat(mask, K)
    w = scatter_apply(
        w,
        [
            (src, d_src, mask),
            (pos, d_pos, mask),
            (negs.reshape(-1), d_neg.reshape(B * K, D), mask_k),
        ],
        collision,
    )
    return w, loss


# --------------------------------------------------------------------- #
# SGNS with SHARED negatives -- the fast path.
#
# Instead of K independent negatives per sample (reference UpdatePair,
# proNet.cpp:1784-1809), one pool of Ks negatives is drawn per step and
# shared by the whole batch, with gradients scaled by K/Ks so the expected
# per-sample update matches. This turns the negative side -- 5/6 of the
# random row traffic -- into dense matmuls:
#     f_neg = V @ C_neg^T            (B, Ks)
#     d_neg = G^T @ V                (Ks, D)
# leaving only 2 gathers + 3 scatters of (B,) rows. Shared negatives are a
# standard sampled-softmax/word2vec-GPU technique; quality parity is
# enforced by the AUC gates.
# --------------------------------------------------------------------- #
def sgns_shared_negs_step(
    w_vertex: jnp.ndarray,
    w_context: jnp.ndarray,
    src: jnp.ndarray,  # (B,)
    pos: jnp.ndarray,  # (B,)
    negs: jnp.ndarray,  # (Ks,) shared negative pool
    alpha: jnp.ndarray,
    k_equiv: int = 5,  # the per-sample negative count being emulated
    mask: Optional[jnp.ndarray] = None,
    shared_table: bool = False,  # True = LINE order-1 (one table)
    update_vertex: bool = True,
    reg: float = 0.0,  # L2 shrink, reference Opt_SigmoidRegSGD
    collision: str = "sum",
    src_group: int = 1,  # src has repeat-layout groups of this size
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """src_group > 1: ``src`` must be ``jnp.repeat(src_small, G)`` -- each
    source contributes G consecutive samples (the walk-style reuse of the
    reference's SkipGrams, proNet.cpp:726-790, applied to edge sampling);
    the source-side delta is segment-summed in-register so the gather and
    scatter shrink by G. Requires mask=None."""
    Ks = negs.shape[0]
    B = src.shape[0]
    if src_group > 1:
        # mask IS allowed with grouping: every per-pair term (g_pos,
        # g_neg, the reg shrink) is masked before the segment sum, so
        # the grouped source delta equals the per-pair sum exactly.
        assert B % src_group == 0
        src_small = src[::src_group]
        v_small = w_vertex.at[src_small].get(mode="promise_in_bounds")
        v = jnp.repeat(v_small, src_group, axis=0)
    else:
        v = w_vertex.at[src].get(mode="promise_in_bounds")  # (B, D)
    cp = w_context.at[pos].get(mode="promise_in_bounds")  # (B, D)
    cn = w_context.at[negs].get(mode="promise_in_bounds")  # (Ks, D)

    s_pos_full = jax.nn.sigmoid(jnp.einsum("bd,bd->b", v, cp))
    f_neg = jnp.dot(v, cn.T, preferred_element_type=jnp.float32)
    s_neg_full = jax.nn.sigmoid(f_neg)

    g_pos = _maybe_mask((1.0 - s_pos_full) * alpha, mask)
    g_neg = (0.0 - s_neg_full) * (alpha * (k_equiv / Ks))
    if mask is not None:
        g_neg = g_neg * mask[:, None]

    d_src = g_pos[:, None] * cp + jnp.dot(
        g_neg, cn, preferred_element_type=jnp.float32
    )
    d_pos = g_pos[:, None] * v
    d_neg = jnp.dot(g_neg.T, v, preferred_element_type=jnp.float32)

    if reg:
        # Reference Opt_SigmoidRegSGD (proNet.cpp:1332-1350) shrinks
        # both rows by alpha*reg per pair, once per batch occurrence.
        ar = alpha * reg
        m1 = 1.0 if mask is None else mask[:, None]
        d_src = d_src - ar * v * m1
        d_pos = d_pos - ar * cp * m1
        d_neg = d_neg - ar * cn * (k_equiv / Ks)
    m = min(1024, B)
    s_pos, s_neg = s_pos_full[:m], s_neg_full[:m]

    # Monitoring loss on a row subsample only: the full (B, Ks) log would
    # cost millions of transcendentals per step.
    eps = 1e-7
    ce = -jnp.log(s_pos + eps) - (k_equiv / Ks) * jnp.sum(
        jnp.log(1.0 - s_neg + eps), axis=-1
    )
    if mask is not None:
        loss = jnp.sum(ce * mask[:m]) / jnp.maximum(mask[:m].sum(), 1.0)
    else:
        loss = jnp.mean(ce)

    if src_group > 1:
        d_src = d_src.reshape(B // src_group, src_group, -1).sum(axis=1)
        src_entry = (src_small, d_src)
    else:
        src_entry = (src, d_src, mask)

    if shared_table:
        w = scatter_apply(
            w_vertex,
            [src_entry, (pos, d_pos, mask), (negs, d_neg)],
            collision,
        )
        return w, w, loss
    w_context = scatter_apply(
        w_context, [(pos, d_pos, mask), (negs, d_neg)], collision
    )
    if update_vertex:
        w_vertex = scatter_apply(w_vertex, [src_entry], collision)
    return w_vertex, w_context, loss


# --------------------------------------------------------------------- #
# Plain dot-product SGD (no sigmoid). Reference Opt_SGD (proNet.cpp:991)
# used by UpdateFactorizedPair / MF (proNet.cpp:2591).
# --------------------------------------------------------------------- #
def mf_step(
    w_vertex: jnp.ndarray,
    w_context: jnp.ndarray,
    src: jnp.ndarray,
    pos: jnp.ndarray,
    negs: jnp.ndarray,
    alpha: jnp.ndarray,
    reg: float = 0.01,
    mask: Optional[jnp.ndarray] = None,
    shared_table: bool = False,
    collision: str = "sum",
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Matrix-factorization squared-ish loss: g = (label - v.c), with L2."""
    v = w_vertex.at[src].get(mode="promise_in_bounds")
    cp = w_context.at[pos].get(mode="promise_in_bounds")
    cn = w_context.at[negs].get(mode="promise_in_bounds")

    g_pos = _maybe_mask((1.0 - jnp.einsum("bd,bd->b", v, cp)) * alpha, mask)
    g_neg = (0.0 - jnp.einsum("bd,bkd->bk", v, cn)) * alpha
    if mask is not None:
        g_neg = g_neg * mask[:, None]

    ar = alpha * reg
    d_src = (
        g_pos[:, None] * cp
        + jnp.einsum("bk,bkd->bd", g_neg, cn)
        - ar * (1 + negs.shape[1]) * v
    )
    d_pos = g_pos[:, None] * v - ar * cp
    d_neg = g_neg[:, :, None] * v[:, None, :] - ar * cn

    B, K, D = d_neg.shape
    mask_k = None if mask is None else jnp.repeat(mask, K)
    w_vertex, w_context = apply_two_tables(
        w_vertex,
        w_context,
        [(src, d_src, mask)],
        [
            (pos, d_pos, mask),
            (negs.reshape(-1), d_neg.reshape(B * K, D), mask_k),
        ],
        shared_table=shared_table,
        collision=collision,
    )
    loss = jnp.mean(g_pos**2) / jnp.maximum(alpha, 1e-12) ** 2
    return w_vertex, w_context, loss


# --------------------------------------------------------------------- #
# BPR. Reference UpdateBPRPair (proNet.cpp:1406-1456): 5 rounds, each with
# a fresh negative; context rows get L2 (0.0025) per round, the vertex row
# accumulates over rounds with L2 (0.025) at the end. Batched form: all
# rounds are computed against the batch snapshot and summed.
# --------------------------------------------------------------------- #
def bpr_step(
    w_vertex: jnp.ndarray,
    w_context: jnp.ndarray,
    user: jnp.ndarray,  # (B,)
    pos: jnp.ndarray,  # (B,)
    negs: jnp.ndarray,  # (B, R) -- R rounds of fresh negatives
    alpha: jnp.ndarray,
    reg_ctx: float = 0.0025,
    reg_vtx: float = 0.025,
    mask: Optional[jnp.ndarray] = None,
    update_vertex: bool = True,
    shared_table: bool = False,
    collision: str = "sum",
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    v = w_vertex.at[user].get(mode="promise_in_bounds")  # (B, D)
    ci = w_context.at[pos].get(mode="promise_in_bounds")  # (B, D)
    cj = w_context.at[negs].get(mode="promise_in_bounds")  # (B, R, D)

    diff = ci[:, None, :] - cj  # (B, R, D)
    f = jnp.einsum("bd,brd->br", v, diff)
    g = jax.nn.sigmoid(-f) * alpha  # Opt_BPRSGD gradient (proNet.cpp:1053)
    if mask is not None:
        g = g * mask[:, None]
        m1 = mask[:, None]
    else:
        m1 = 1.0

    R = negs.shape[1]
    ar_c = alpha * reg_ctx
    # context_i: sum over rounds of (g*v - L2*ci); context_j: -(g*v) - L2*cj
    d_ci = jnp.einsum("br,bd->bd", g, v) - ar_c * R * ci * m1
    d_cj = -g[:, :, None] * v[:, None, :] - ar_c * cj * (
        1.0 if mask is None else mask[:, None, None]
    )
    d_v = jnp.einsum("br,brd->bd", g, diff) - alpha * reg_vtx * v * m1

    B, _, D = d_cj.shape
    mask_r = None if mask is None else jnp.repeat(mask, R)
    w_vertex, w_context = apply_two_tables(
        w_vertex,
        w_context,
        [(user, d_v, mask)],
        [
            (pos, d_ci, mask),
            (negs.reshape(-1), d_cj.reshape(B * R, D), mask_r),
        ],
        shared_table=shared_table,
        update_vertex=update_vertex,
        collision=collision,
    )

    loss = jnp.mean(jax.nn.softplus(-f))
    return w_vertex, w_context, loss


# --------------------------------------------------------------------- #
# WARP / WSABIE. Reference UpdateWARPPair (proNet.cpp:1353-1404): up to 32
# negative trials; the FIRST with margin violation (v.(ci-cj) < 1) triggers
# one BPR-style update (+ L2 0.0025 on all three rows), then break.
# Batched form: score all trials at once, select the first violator by argmax
# over the violation mask (SURVEY.md 7.3).
# --------------------------------------------------------------------- #
def warp_step(
    w_vertex: jnp.ndarray,
    w_context: jnp.ndarray,
    user: jnp.ndarray,  # (B,)
    pos: jnp.ndarray,  # (B,)
    negs: jnp.ndarray,  # (B, T) candidate negatives (T ~ 32)
    alpha: jnp.ndarray,
    reg: float = 0.0025,
    mask: Optional[jnp.ndarray] = None,
    shared_table: bool = False,
    collision: str = "sum",
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    v = w_vertex.at[user].get(mode="promise_in_bounds")
    ci = w_context.at[pos].get(mode="promise_in_bounds")
    cj = w_context.at[negs].get(mode="promise_in_bounds")  # (B, T, D)

    f = jnp.einsum("bd,btd->bt", v, ci[:, None, :] - cj)
    violated = f < 1.0  # margin violation mask
    any_viol = jnp.any(violated, axis=1)
    first = jnp.argmax(violated, axis=1)  # first True (0 if none -> masked)

    j = jnp.take_along_axis(negs, first[:, None], axis=1)[:, 0]  # (B,)
    cjf = w_context.at[j].get(mode="promise_in_bounds")
    diff = ci - cjf
    fsel = jnp.einsum("bd,bd->b", v, diff)
    g = jax.nn.sigmoid(-fsel) * alpha
    act = any_viol.astype(w_vertex.dtype)
    if mask is not None:
        act = act * mask
    g = g * act

    ar = alpha * reg
    d_v = g[:, None] * diff - ar * v * act[:, None]
    d_ci = g[:, None] * v - ar * ci * act[:, None]
    d_cj = -g[:, None] * v - ar * cjf * act[:, None]

    w_vertex, w_context = apply_two_tables(
        w_vertex,
        w_context,
        [(user, d_v, act)],
        [(pos, d_ci, act), (j, d_cj, act)],
        shared_table=shared_table,
        collision=collision,
    )
    loss = jnp.sum(jax.nn.relu(1.0 - fsel) * act) / jnp.maximum(jnp.sum(act), 1.0)
    return w_vertex, w_context, loss


# --------------------------------------------------------------------- #
# Skew-OPT (UAI'20). Reference Opt_SBPRSGD (proNet.cpp:1070-1098) inside
# UpdateSBPRPair (proNet.cpp:1517-1566, 16 negatives): on x = v.(ci-cj),
# let t = (x - xi)/omega, clamp below at -2, SKIP the round if t > 2;
# g = sigmoid(-t^eta) * t^(eta-1) / omega. Per SUCCESSFUL round the
# reference L2-shrinks ci and cj by alpha*0.01 (hardcoded, the CLI's
# -reg is ignored) then applies +/- g*v; the VERTEX delta is the
# AVERAGE of g*(ci-cj) over successful rounds, with one alpha*0.01
# shrink iff any round succeeded (proNet.cpp:1540-1565).
# --------------------------------------------------------------------- #
def skewbpr_step(
    w_vertex: jnp.ndarray,
    w_context: jnp.ndarray,
    user: jnp.ndarray,
    pos: jnp.ndarray,
    negs: jnp.ndarray,  # (B, R)
    alpha: jnp.ndarray,
    xi: float = 0.0,
    omega: float = 1.0,
    eta: int = 1,
    reg: float = 0.01,
    mask: Optional[jnp.ndarray] = None,
    shared_table: bool = False,
    collision: str = "sum",
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    v = w_vertex.at[user].get(mode="promise_in_bounds")
    ci0 = w_context.at[pos].get(mode="promise_in_bounds")
    cj = w_context.at[negs].get(mode="promise_in_bounds")

    # The reference applies each successful round's shrink+update to
    # w_context[ci] IN PLACE before the next round recomputes
    # x = v.(ci - cj) (proNet.cpp:1532-1553), so ci must evolve across
    # the R rounds; a lax.scan keeps it in registers. v stays fixed
    # (vertex_err is deferred to the end).
    ar = alpha * reg
    maskb = None if mask is None else mask.astype(w_vertex.dtype)

    def round_fn(carry, cj_r):
        ci_cur, ev, n_succ, loss_acc = carry
        x = jnp.sum(v * (ci_cur - cj_r), axis=-1)  # (B,)
        t = (x - xi) / omega
        succ = (t <= 2.0).astype(w_vertex.dtype)
        if maskb is not None:
            succ = succ * maskb
        t = jnp.clip(t, -2.0, None)
        t_pow = t**eta
        # chain factor t^(eta-1); eta is static, resolved at trace time
        chain = jnp.ones_like(t) if eta == 1 else t ** (eta - 1)
        g = jax.nn.sigmoid(-t_pow) * chain / omega * alpha * succ
        ci_next = ci_cur + (-ar * ci_cur + g[:, None] * v) * succ[:, None]
        d_cj_r = (-ar * cj_r - g[:, None] * v) * succ[:, None]
        ev = ev + g[:, None] * (ci_cur - cj_r)
        return (
            ci_next,
            ev,
            n_succ + succ,
            loss_acc + jnp.mean(jax.nn.softplus(-x)),
        ), d_cj_r

    R = negs.shape[1]
    init = (
        ci0,
        jnp.zeros_like(ci0),
        jnp.zeros(ci0.shape[0], dtype=w_vertex.dtype),
        jnp.zeros((), dtype=w_vertex.dtype),
    )
    (ci_fin, ev, n_succ, loss_acc), d_cj_scan = jax.lax.scan(
        round_fn, init, jnp.swapaxes(cj, 0, 1)
    )
    any_succ = (n_succ > 0).astype(w_vertex.dtype)
    d_ci = ci_fin - ci0
    d_cj = jnp.swapaxes(d_cj_scan, 0, 1)  # (B, R, D)
    d_v = (
        ev / jnp.maximum(n_succ, 1.0)[:, None]
        - ar * v * any_succ[:, None]
    )
    B, R, D = d_cj.shape
    mask_r = None if mask is None else jnp.repeat(mask, R)
    w_vertex, w_context = apply_two_tables(
        w_vertex,
        w_context,
        [(user, d_v, mask)],
        [
            (pos, d_ci, mask),
            (negs.reshape(-1), d_cj.reshape(B * R, D), mask_r),
        ],
        shared_table=shared_table,
        collision=collision,
    )
    loss = loss_acc / R  # mean per-round softplus(-x)
    return w_vertex, w_context, loss


# --------------------------------------------------------------------- #
# SHARED-POOL rec kernels (round 3, VERDICT r2 #6). The per-sample rec
# kernels above gather/scatter (1 + R) context rows PER SAMPLE (R = 5
# BPR rounds / 32 WARP trials). These variants draw ONE pool of Ks
# negatives per step and score every sample against the whole pool as
# one matmul, scaling gradients by k_equiv/Ks -- the same
# expectation-preserving transform as sgns_shared_negs_step (each
# negative term is an independent draw from the negative law, so
# E_pool[update] == E_fresh[update]; within-step correlation is the only
# change). Quality is gated by experiments/bpr_parity.py AUC/recall@10.
# --------------------------------------------------------------------- #
def bpr_shared_negs_step(
    w_vertex: jnp.ndarray,
    w_context: jnp.ndarray,
    user: jnp.ndarray,  # (B,)
    pos: jnp.ndarray,  # (B,)
    negs: jnp.ndarray,  # (Ks,) shared pool
    alpha: jnp.ndarray,
    k_equiv: int = 5,  # the reference's 5 rounds (UpdateBPRPair)
    reg_ctx: float = 0.0025,
    reg_vtx: float = 0.025,
    shared_table: bool = False,
    collision: str = "sum",
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    v = w_vertex.at[user].get(mode="promise_in_bounds")  # (B, D)
    ci = w_context.at[pos].get(mode="promise_in_bounds")
    cn = w_context.at[negs].get(mode="promise_in_bounds")  # (Ks, D)
    B = user.shape[0]
    Ks = negs.shape[0]

    f_i = jnp.einsum("bd,bd->b", v, ci)
    f_j = jnp.dot(v, cn.T, preferred_element_type=jnp.float32)  # (B, Ks)
    g = jax.nn.sigmoid(f_j - f_i[:, None]) * (alpha * (k_equiv / Ks))

    ar_c = alpha * reg_ctx
    gs = jnp.sum(g, axis=1)  # (B,)
    d_ci = gs[:, None] * v - ar_c * k_equiv * ci
    d_cn = -jnp.dot(g.T, v, preferred_element_type=jnp.float32) - (
        ar_c * (B * k_equiv / Ks)
    ) * cn
    d_v = gs[:, None] * ci - jnp.dot(
        g, cn, preferred_element_type=jnp.float32
    ) - alpha * reg_vtx * v

    w_vertex, w_context = apply_two_tables(
        w_vertex, w_context,
        [(user, d_v, None)],
        [(pos, d_ci, None), (negs, d_cn, None)],
        shared_table=shared_table, collision=collision,
    )
    loss = jnp.mean(jax.nn.softplus(f_j - f_i[:, None]))
    return w_vertex, w_context, loss


def mf_shared_negs_step(
    w_vertex: jnp.ndarray,
    w_context: jnp.ndarray,
    src: jnp.ndarray,
    pos: jnp.ndarray,
    negs: jnp.ndarray,  # (Ks,)
    alpha: jnp.ndarray,
    k_equiv: int = 5,
    reg: float = 0.01,
    shared_table: bool = False,
    collision: str = "sum",
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Shared-pool form of mf_step (UpdateFactorizedPair law)."""
    v = w_vertex.at[src].get(mode="promise_in_bounds")
    cp = w_context.at[pos].get(mode="promise_in_bounds")
    cn = w_context.at[negs].get(mode="promise_in_bounds")
    B = src.shape[0]
    Ks = negs.shape[0]

    g_pos = (1.0 - jnp.einsum("bd,bd->b", v, cp)) * alpha
    g_neg = (
        0.0 - jnp.dot(v, cn.T, preferred_element_type=jnp.float32)
    ) * (alpha * (k_equiv / Ks))

    ar = alpha * reg
    d_src = (
        g_pos[:, None] * cp
        + jnp.dot(g_neg, cn, preferred_element_type=jnp.float32)
        - ar * (1 + k_equiv) * v
    )
    d_pos = g_pos[:, None] * v - ar * cp
    d_cn = jnp.dot(
        g_neg.T, v, preferred_element_type=jnp.float32
    ) - ar * (B * k_equiv / Ks) * cn

    w_vertex, w_context = apply_two_tables(
        w_vertex, w_context,
        [(src, d_src, None)],
        [(pos, d_pos, None), (negs, d_cn, None)],
        shared_table=shared_table, collision=collision,
    )
    loss = jnp.mean(g_pos**2) / jnp.maximum(alpha, 1e-12) ** 2
    return w_vertex, w_context, loss


def warp_shared_pool_step(
    w_vertex: jnp.ndarray,
    w_context: jnp.ndarray,
    user: jnp.ndarray,  # (B,)
    pos: jnp.ndarray,  # (B,)
    negs: jnp.ndarray,  # (Ks,) shared candidate pool
    u: jnp.ndarray,  # (B, Ks + 1) uniforms: [:, :Ks] break ties for the
    # violator choice, [:, Ks] gates the <=T-trial success probability
    alpha: jnp.ndarray,
    trials: int = 32,
    reg: float = 0.0025,
    shared_table: bool = False,
    collision: str = "sum",
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Shared-pool form of warp_step, with the trial loop MARGINALIZED:
    the reference draws up to ``trials`` iid candidates and updates with
    the first margin violator (UpdateWARPPair, proNet.cpp:1353-1404).
    Over iid draws from the pool, "first violator" is a uniformly random
    member of the violating subset, and an update happens with
    probability 1 - (1 - v)^trials where v is the violating fraction --
    both computed exactly here (no per-sample trial walk: no
    take_along_axis over (B, Ks))."""
    v = w_vertex.at[user].get(mode="promise_in_bounds")
    ci = w_context.at[pos].get(mode="promise_in_bounds")
    cn = w_context.at[negs].get(mode="promise_in_bounds")  # (Ks, D)
    Ks = negs.shape[0]

    f_i = jnp.einsum("bd,bd->b", v, ci)  # (B,)
    f_pool = jnp.dot(v, cn.T, preferred_element_type=jnp.float32)
    violated = (f_i[:, None] - f_pool) < 1.0  # (B, Ks)
    vfrac = violated.mean(axis=1)
    p_hit = 1.0 - (1.0 - vfrac) ** trials
    any_viol = u[:, Ks] < p_hit  # Bernoulli(trial-success probability)
    # uniformly random violator: argmax of uniforms masked to violators
    k_sel = jnp.argmax(jnp.where(violated, u[:, :Ks], -1.0), axis=1)
    j = negs.at[k_sel].get(mode="promise_in_bounds")  # (B,) global vid
    cjf = cn.at[k_sel].get(mode="promise_in_bounds")  # (B, D)

    diff = ci - cjf
    fsel = jnp.einsum("bd,bd->b", v, diff)
    act = any_viol.astype(w_vertex.dtype)
    g = jax.nn.sigmoid(-fsel) * alpha * act

    ar = alpha * reg
    d_v = g[:, None] * diff - ar * v * act[:, None]
    d_ci = g[:, None] * v - ar * ci * act[:, None]
    d_cj = -g[:, None] * v - ar * cjf * act[:, None]

    w_vertex, w_context = apply_two_tables(
        w_vertex, w_context,
        [(user, d_v, act)],
        [(pos, d_ci, act), (j, d_cj, act)],
        shared_table=shared_table, collision=collision,
    )
    loss = jnp.sum(jax.nn.relu(1.0 - fsel) * act) / jnp.maximum(
        jnp.sum(act), 1.0
    )
    return w_vertex, w_context, loss


def skewbpr_shared_negs_step(
    w_vertex: jnp.ndarray,
    w_context: jnp.ndarray,
    user: jnp.ndarray,
    pos: jnp.ndarray,
    negs: jnp.ndarray,  # (Ks,) shared pool
    alpha: jnp.ndarray,
    k_equiv: int = 16,  # UpdateSBPRPair's 16 rounds
    xi: float = 0.0,
    omega: float = 1.0,
    eta: int = 1,
    reg: float = 0.01,
    shared_table: bool = False,
    collision: str = "sum",
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Shared-pool Skew-OPT: each of the reference's k_equiv sequential
    rounds is taken in EXPECTATION over the pool (weight 1/Ks), with the
    positive row still evolving across rounds like the reference's
    in-place updates (skewbpr_step's scan)."""
    v = w_vertex.at[user].get(mode="promise_in_bounds")
    ci0 = w_context.at[pos].get(mode="promise_in_bounds")
    cn = w_context.at[negs].get(mode="promise_in_bounds")  # (Ks, D)
    B = user.shape[0]
    Ks = negs.shape[0]
    ar = alpha * reg
    f_cn = jnp.dot(v, cn.T, preferred_element_type=jnp.float32)  # (B,Ks)

    def round_fn(carry, _):
        ci_cur, ev, n_succ, d_cn_acc, loss_acc = carry
        x = jnp.einsum("bd,bd->b", v, ci_cur)[:, None] - f_cn  # (B, Ks)
        t = (x - xi) / omega
        succ = (t <= 2.0).astype(w_vertex.dtype)
        t = jnp.clip(t, -2.0, None)
        chain = jnp.ones_like(t) if eta == 1 else t ** (eta - 1)
        g = jax.nn.sigmoid(-(t**eta)) * chain / omega * alpha * succ
        w_pool = 1.0 / Ks
        succ_b = jnp.sum(succ, axis=1) * w_pool  # expected succ per round
        g_sum = jnp.sum(g, axis=1) * w_pool
        ci_next = ci_cur + (
            -ar * ci_cur * succ_b[:, None] + g_sum[:, None] * v
        )
        d_cn_acc = d_cn_acc - w_pool * (
            jnp.dot(g.T, v, preferred_element_type=jnp.float32)
            + ar * jnp.sum(succ, axis=0)[:, None] * cn
        )
        ev = ev + g_sum[:, None] * ci_cur - w_pool * jnp.dot(
            g, cn, preferred_element_type=jnp.float32
        )
        return (
            ci_next, ev, n_succ + succ_b,
            d_cn_acc, loss_acc + jnp.mean(jax.nn.softplus(-x)),
        ), None

    init = (
        ci0, jnp.zeros_like(ci0),
        jnp.zeros(B, dtype=w_vertex.dtype),
        jnp.zeros_like(cn), jnp.zeros((), dtype=w_vertex.dtype),
    )
    (ci_fin, ev, n_succ, d_cn, loss_acc), _ = jax.lax.scan(
        round_fn, init, None, length=k_equiv
    )
    any_succ = (n_succ > 0).astype(w_vertex.dtype)
    d_ci = ci_fin - ci0
    d_v = (
        ev / jnp.maximum(n_succ, 1.0)[:, None]
        - ar * v * any_succ[:, None]
    )
    w_vertex, w_context = apply_two_tables(
        w_vertex, w_context,
        [(user, d_v, None)],
        [(pos, d_ci, None), (negs, d_cn, None)],
        shared_table=shared_table, collision=collision,
    )
    return w_vertex, w_context, loss_acc / k_equiv


# --------------------------------------------------------------------- #
# PU (positive-unlabeled) variants. Reference Opt_PUSGD (proNet.cpp:1249),
# Opt_PUSigmoidSGD (proNet.cpp:1279), Opt_PUBPRSGD (proNet.cpp:1033).
# These are experimental kernels in the reference (no shipped CLI uses
# them); implemented for inventory parity (SURVEY.md section 2.1).
# --------------------------------------------------------------------- #
def pu_sgd_step(
    w_vertex: jnp.ndarray,
    w_context: jnp.ndarray,
    src: jnp.ndarray,  # (B,)
    ctx: jnp.ndarray,  # (B,)
    labels: jnp.ndarray,  # (B,) 1.0 = positive, 0.0 = unlabeled
    alpha: jnp.ndarray,
    reg: float = 0.01,
    mask: Optional[jnp.ndarray] = None,
    collision: str = "sum",
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Batched Opt_PUSGD (proNet.cpp:1249-1277): g = label - v.c; the
    positive branch uses a risk-weighted gradient (alpha*g + 1), the
    unlabeled branch the plain MF gradient; both shrink by reg."""
    v = w_vertex.at[src].get(mode="promise_in_bounds")
    c = w_context.at[ctx].get(mode="promise_in_bounds")
    f = jnp.einsum("bd,bd->b", v, c)
    g = labels - f
    gw = jnp.where(labels == 1.0, alpha * g + 1.0, g)  # positive reweight
    gw = _maybe_mask(gw, mask)
    m1 = 1.0 if mask is None else mask[:, None]
    d_v = alpha * (gw[:, None] * c - reg * v * m1)
    d_c = alpha * (gw[:, None] * v - reg * c * m1)
    w_vertex, w_context = apply_two_tables(
        w_vertex, w_context, [(src, d_v, mask)], [(ctx, d_c, mask)],
        collision=collision,
    )
    loss = jnp.mean(g * g)
    return w_vertex, w_context, loss


def pu_sigmoid_step(
    w_vertex: jnp.ndarray,
    w_context: jnp.ndarray,
    src: jnp.ndarray,
    ctx: jnp.ndarray,
    labels: jnp.ndarray,  # (B,) 1.0 positive, 0.0 unlabeled/negative
    alpha: jnp.ndarray,
    reg: float = 0.0025,
    mask: Optional[jnp.ndarray] = None,
    collision: str = "sum",
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Batched Opt_PUSigmoidSGD (proNet.cpp:1279-1310).

    positive: d_v = alpha*(sigmoid(-f) + 2*alpha)*c - alpha*reg*v
              d_c = alpha* sigmoid(-f)*v           - alpha*reg*c
    unlabeled: d_v = -alpha*(sigmoid(f)*c + reg*v)  (and symmetrically c)
    """
    v = w_vertex.at[src].get(mode="promise_in_bounds")
    c = w_context.at[ctx].get(mode="promise_in_bounds")
    f = jnp.einsum("bd,bd->b", v, c)
    is_pos = labels == 1.0
    s_neg_f = jax.nn.sigmoid(-f)  # positive-branch factor
    s_pos_f = jax.nn.sigmoid(f)  # unlabeled-branch factor
    m1 = 1.0 if mask is None else mask[:, None]
    mb = 1.0 if mask is None else mask

    gv_pos = alpha * (s_neg_f + 2.0 * alpha)
    gc_pos = alpha * s_neg_f
    d_v = jnp.where(
        is_pos[:, None],
        gv_pos[:, None] * c - alpha * reg * v,
        -(alpha * s_pos_f)[:, None] * c - alpha * reg * v,
    ) * m1
    d_c = jnp.where(
        is_pos[:, None],
        gc_pos[:, None] * v - alpha * reg * c,
        -(alpha * s_pos_f)[:, None] * v - alpha * reg * c,
    ) * m1
    w_vertex, w_context = apply_two_tables(
        w_vertex, w_context, [(src, d_v, mask)], [(ctx, d_c, mask)],
        collision=collision,
    )
    ce = jnp.where(is_pos, -jnp.log(jax.nn.sigmoid(f) + 1e-7),
                   -jnp.log(1.0 - jax.nn.sigmoid(f) + 1e-7)) * mb
    if mask is None:
        loss = jnp.mean(ce)
    else:
        loss = ce.sum() / jnp.maximum(mask.sum(), 1.0)
    return w_vertex, w_context, loss


def pu_bpr_step(
    w_vertex: jnp.ndarray,
    w_context: jnp.ndarray,
    user: jnp.ndarray,
    pos: jnp.ndarray,
    negs: jnp.ndarray,  # (B, R)
    alpha: jnp.ndarray,
    mask: Optional[jnp.ndarray] = None,
    shared_table: bool = False,
    collision: str = "sum",
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Batched Opt_PUBPRSGD (proNet.cpp:1033-1051): the live branch is
    numerically identical to Opt_BPRSGD (g = sigmoid(-f)) with zero L2 --
    the PU reweighting is commented out in the reference."""
    return bpr_step(
        w_vertex, w_context, user, pos, negs, alpha,
        reg_ctx=0.0, reg_vtx=0.0, mask=mask, shared_table=shared_table,
        collision=collision,
    )


# --------------------------------------------------------------------- #
# Cosine-similarity SGD. Reference Opt_CosineSGD (proNet.cpp:1180-1247)
# inside UpdateCosinePair (proNet.cpp:1714-1782): positive pair label 1,
# negative_samples fresh negatives label -1; gradient of
# (label - cos(v,c)) wrt both rows, applied immediately (batched here).
# --------------------------------------------------------------------- #
def cosine_step(
    w_vertex: jnp.ndarray,
    w_context: jnp.ndarray,
    src: jnp.ndarray,  # (B,)
    pos: jnp.ndarray,  # (B,)
    negs: jnp.ndarray,  # (B, K)
    alpha: jnp.ndarray,
    mask: Optional[jnp.ndarray] = None,
    collision: str = "sum",
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    eps = 1e-8

    def cos_deltas(v, c, label):
        vl = jnp.linalg.norm(v, axis=-1, keepdims=True) + eps  # (...,1)
        cl = jnp.linalg.norm(c, axis=-1, keepdims=True) + eps
        f = jnp.sum(v * c, axis=-1, keepdims=True) / (vl * cl)  # cosine
        err = (label - f) * alpha
        # d cos/d v = c/(|v||c|) - v*cos/|v|^2 (proNet.cpp:1208-1212)
        d_v = err * (c / (vl * cl) - v * f / (vl * vl))
        d_c = err * (v / (vl * cl) - c * f / (cl * cl))
        return d_v, d_c, f

    v = w_vertex.at[src].get(mode="promise_in_bounds")  # (B,D)
    cp = w_context.at[pos].get(mode="promise_in_bounds")
    cn = w_context.at[negs].get(mode="promise_in_bounds")  # (B,K,D)

    d_v1, d_cp, f_pos = cos_deltas(v, cp, 1.0)
    d_v2, d_cn, f_neg = cos_deltas(v[:, None, :], cn, -1.0)
    d_v = d_v1 + d_v2.sum(axis=1)
    if mask is not None:
        d_v = d_v * mask[:, None]
        d_cp = d_cp * mask[:, None]
        d_cn = d_cn * mask[:, None, None]

    B, K, D = d_cn.shape
    mask_k = None if mask is None else jnp.repeat(mask, K)
    w_context = scatter_apply(
        w_context,
        [(pos, d_cp, mask), (negs.reshape(-1), d_cn.reshape(B * K, D), mask_k)],
        collision,
    )
    w_vertex = scatter_apply(w_vertex, [(src, d_v, mask)], collision)
    loss = jnp.mean((1.0 - f_pos) ** 2) + jnp.mean((-1.0 - f_neg) ** 2)
    return w_vertex, w_context, loss


# --------------------------------------------------------------------- #
# Length (norm-product) SGD. Reference Opt_LengthSGD (proNet.cpp:1121-
# 1178) inside UpdateLengthPair (proNet.cpp:1635-1712): pulls the PRODUCT
# of the two rows' norms toward the label (1 for pos, 0 for neg -- the
# reference maps label -1 -> 0 at proNet.cpp:1152-1155); deltas are
# SUBTRACTED (gradient descent on (|v||c| - label)^2).
# --------------------------------------------------------------------- #
def length_step(
    w_vertex: jnp.ndarray,
    w_context: jnp.ndarray,
    src: jnp.ndarray,
    pos: jnp.ndarray,
    negs: jnp.ndarray,  # (B, K)
    alpha: jnp.ndarray,
    mask: Optional[jnp.ndarray] = None,
    collision: str = "sum",
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    eps = 1e-8

    def len_deltas(v, c, label):
        vl = jnp.linalg.norm(v, axis=-1, keepdims=True) + eps
        cl = jnp.linalg.norm(c, axis=-1, keepdims=True) + eps
        vc = vl * cl
        # g_v = 2 v |c| (|v||c| - label)/|v| (proNet.cpp:1160-1161)
        d_v = -alpha * 2.0 * v * cl * (vc - label) / vl
        d_c = -alpha * 2.0 * c * vl * (vc - label) / cl
        return d_v, d_c, vc

    v = w_vertex.at[src].get(mode="promise_in_bounds")
    cp = w_context.at[pos].get(mode="promise_in_bounds")
    cn = w_context.at[negs].get(mode="promise_in_bounds")

    d_v1, d_cp, vc_pos = len_deltas(v, cp, 1.0)
    d_v2, d_cn, vc_neg = len_deltas(v[:, None, :], cn, 0.0)
    d_v = d_v1 + d_v2.sum(axis=1)
    if mask is not None:
        d_v = d_v * mask[:, None]
        d_cp = d_cp * mask[:, None]
        d_cn = d_cn * mask[:, None, None]

    B, K, D = d_cn.shape
    mask_k = None if mask is None else jnp.repeat(mask, K)
    w_context = scatter_apply(
        w_context,
        [(pos, d_cp, mask), (negs.reshape(-1), d_cn.reshape(B * K, D), mask_k)],
        collision,
    )
    w_vertex = scatter_apply(w_vertex, [(src, d_v, mask)], collision)
    loss = jnp.mean((vc_pos - 1.0) ** 2) + jnp.mean(vc_neg**2)
    return w_vertex, w_context, loss


# --------------------------------------------------------------------- #
# Grouping pair. Reference UpdateGroupingPair (proNet.cpp:1811-1885):
# sums a small GROUP of vertex rows (the vertex, its 2-hop walk endpoint
# -- which the reference pushes twice due to a loop quirk at
# proNet.cpp:1832: the context's 2-hop endpoint is appended to the
# VERTEX list) and the context row, runs one Opt_SGD on the summed
# vectors, and adds the same back-error to every group member.
# --------------------------------------------------------------------- #
def grouping_step(
    w_vertex: jnp.ndarray,
    w_context: jnp.ndarray,
    vgroup: jnp.ndarray,  # (B, Gv) vertex-group rows (duplicates allowed)
    cgroup: jnp.ndarray,  # (B, Gc) context-group rows
    labels: jnp.ndarray,  # (B,)
    alpha: jnp.ndarray,
    reg: float = 0.01,
    mask: Optional[jnp.ndarray] = None,
    shared_table: bool = False,
    collision: str = "sum",
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    v_sum = jnp.sum(w_vertex.at[vgroup].get(mode="promise_in_bounds"), axis=1)
    c_sum = jnp.sum(w_context.at[cgroup].get(mode="promise_in_bounds"), axis=1)
    f = jnp.einsum("bd,bd->b", v_sum, c_sum)
    g = _maybe_mask((labels - f) * alpha, mask)  # Opt_SGD (proNet.cpp:991)
    m1 = 1.0 if mask is None else mask[:, None]
    d_v = g[:, None] * c_sum - alpha * reg * v_sum * m1
    d_c = g[:, None] * v_sum - alpha * reg * c_sum * m1

    B, Gv = vgroup.shape
    Gc = cgroup.shape[1]
    D = d_v.shape[-1]
    rep_v = jnp.broadcast_to(d_v[:, None, :], (B, Gv, D)).reshape(B * Gv, D)
    rep_c = jnp.broadcast_to(d_c[:, None, :], (B, Gc, D)).reshape(B * Gc, D)
    mask_v = None if mask is None else jnp.repeat(mask, Gv)
    mask_c = None if mask is None else jnp.repeat(mask, Gc)
    w_vertex, w_context = apply_two_tables(
        w_vertex, w_context,
        [(vgroup.reshape(-1), rep_v, mask_v)],
        [(cgroup.reshape(-1), rep_c, mask_c)],
        shared_table=shared_table, collision=collision,
    )
    loss = jnp.mean((labels - f) ** 2)
    return w_vertex, w_context, loss


# --------------------------------------------------------------------- #
# Margin-filtered BPR with decay (HOP-REC). Reference UpdateFBPRPair
# (proNet.cpp:1458-1515) via Opt_FBPRSGD (proNet.cpp:1014-1031): skip the
# update when f = v.(ci-cj) already exceeds the margin.
# --------------------------------------------------------------------- #
def fbpr_step(
    w_vertex: jnp.ndarray,
    w_context: jnp.ndarray,
    user: jnp.ndarray,
    pos: jnp.ndarray,
    negs: jnp.ndarray,  # (B, R)
    alpha: jnp.ndarray,  # scalar OR (B,) per-pair (HOP-REC decays by hop)
    margin: jnp.ndarray,  # scalar OR (B,)
    reg_ctx: float = 0.0025,
    reg_vtx: float = 0.025,
    mask: Optional[jnp.ndarray] = None,
    shared_table: bool = False,
    collision: str = "sum",
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    v = w_vertex.at[user].get(mode="promise_in_bounds")
    ci = w_context.at[pos].get(mode="promise_in_bounds")
    cj = w_context.at[negs].get(mode="promise_in_bounds")

    alpha_b = jnp.broadcast_to(jnp.asarray(alpha), user.shape)  # (B,)
    margin_b = jnp.broadcast_to(jnp.asarray(margin), user.shape)

    diff = ci[:, None, :] - cj
    f = jnp.einsum("bd,brd->br", v, diff)
    # Margin gating: Opt_FBPRSGD returns 0 when f > margin and the
    # reference then skips the round's reg AND update; the vertex error
    # is AVERAGED over successful rounds, shrunk once iff any succeeded
    # (proNet.cpp:1492-1515).
    active = (f <= margin_b[:, None]).astype(w_vertex.dtype)
    g = jax.nn.sigmoid(-f) * alpha_b[:, None] * active
    if mask is not None:
        g = g * mask[:, None]
        active = active * mask[:, None]

    n_act = active.sum(axis=-1)  # (B,)
    act_any = (n_act > 0).astype(w_vertex.dtype)
    ar_c = (alpha_b * reg_ctx)[:, None]
    d_ci = jnp.einsum("br,bd->bd", g, v) - ar_c * n_act[:, None] * ci
    d_cj = -g[:, :, None] * v[:, None, :] - ar_c[:, :, None] * cj * active[:, :, None]
    d_v = (
        jnp.einsum("br,brd->bd", g, diff) / jnp.maximum(n_act, 1.0)[:, None]
        - (alpha_b * reg_vtx)[:, None] * v * act_any[:, None]
    )

    B, R, D = d_cj.shape
    mask_r = None if mask is None else jnp.repeat(mask, R)
    w_vertex, w_context = apply_two_tables(
        w_vertex,
        w_context,
        [(user, d_v, mask)],
        [
            (pos, d_ci, mask),
            (negs.reshape(-1), d_cj.reshape(B * R, D), mask_r),
        ],
        shared_table=shared_table,
        collision=collision,
    )
    loss = jnp.mean(jax.nn.softplus(-f))
    return w_vertex, w_context, loss


# --------------------------------------------------------------------- #
# BANDED shared-negatives SGNS -- the large-table path.
#
# The banded step receives a batch whose positive contexts all lie in ONE
# band of rows (drawn band-stratified by BandedTables.draw_banded_batch,
# which preserves the exact reference edge-sample law -- see
# smore_tpu/sampling/banded.py), slices that band out of the big table,
# scatters into the slice, and writes the band back, so the random-row
# scatters address a small table. Negative (and order-1 source) updates
# may land anywhere, so they are band-split: rows inside the band update
# the slice, the rest update the big table (both tiny row counts).
# --------------------------------------------------------------------- #
def sgns_shared_negs_step_banded(
    w_vertex: jnp.ndarray,  # (Np, D); == w_context when shared_table
    w_context: jnp.ndarray,  # (Np, D), Np padded to a band multiple
    band_start: jnp.ndarray,  # () int32, first row of the contexts' band
    band_size: int,  # static
    src: jnp.ndarray,  # (B,) repeat layout when src_group > 1
    pos: jnp.ndarray,  # (B,) GLOBAL vids, all inside the band
    negs: jnp.ndarray,  # (Ks,) global shared negative pool
    alpha: jnp.ndarray,
    k_equiv: int = 5,
    shared_table: bool = False,  # LINE order-1
    src_group: int = 1,
    src_band_start: Optional[jnp.ndarray] = None,  # 2D strata: all src
    # fall in [src_band_start, +band_size) and the w_vertex gather /
    # scatter ride a band slice too (sampling/banded.py two_d=True)
    precision=SGNS_PRECISION,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Semantics = sgns_shared_negs_step(collision="sum") on the same
    (src, pos, negs); only the scatter routing differs (verified in
    tests/test_banded.py)."""
    Ks = negs.shape[0]
    B = src.shape[0]
    D = w_context.shape[1]
    n_pad = w_context.shape[0]
    G = src_group
    src_banded = src_band_start is not None and not shared_table
    assert not (shared_table and src_band_start is not None), (
        "2D banding is for two-table mode; order-1 uses 1D tables"
    )

    ds = jax.lax.dynamic_slice(w_context, (band_start, 0), (band_size, D))
    pos_l = pos - band_start

    if src_banded:
        dsv = jax.lax.dynamic_slice(
            w_vertex, (src_band_start, 0), (band_size, D)
        )
        v_table, src_idx = dsv, src - src_band_start
    else:
        v_table, src_idx = w_vertex, src
    if G > 1:
        src_small = src_idx[::G]
        v_small = v_table.at[src_small].get(mode="promise_in_bounds")
        v = jnp.repeat(v_small, G, axis=0)
    else:
        v = v_table.at[src_idx].get(mode="promise_in_bounds")
    cp = ds.at[pos_l].get(mode="promise_in_bounds")
    cn = w_context.at[negs].get(mode="promise_in_bounds")

    dot = partial(jnp.dot, precision=precision,
                  preferred_element_type=jnp.float32)
    s_pos_full = jax.nn.sigmoid(jnp.einsum("bd,bd->b", v, cp))
    s_neg_full = jax.nn.sigmoid(dot(v, cn.T))
    g_pos = (1.0 - s_pos_full) * alpha
    g_neg = (0.0 - s_neg_full) * (alpha * (k_equiv / Ks))
    d_src = g_pos[:, None] * cp + dot(g_neg, cn)
    d_pos = g_pos[:, None] * v
    d_neg = dot(g_neg.T, v)

    ds = ds.at[pos_l].add(d_pos, mode="promise_in_bounds")

    # negatives: band-split (both scatters are Ks rows -- tiny)
    negs_l = negs - band_start
    in_b = (negs_l >= 0) & (negs_l < band_size)
    ds = ds.at[jnp.where(in_b, negs_l, band_size)].add(d_neg, mode="drop")
    w_context = w_context.at[jnp.where(in_b, n_pad, negs)].add(
        d_neg, mode="drop"
    )

    if G > 1:
        d_src_x = d_src.reshape(B // G, G, D).sum(axis=1)
        src_x = src_small  # already band-local when src_banded
    else:
        d_src_x, src_x = d_src, src_idx
    if shared_table:
        # order-1: source rows live in the SAME table -> band-split them
        # so the band write-back cannot clobber their updates
        src_l = src_x - band_start
        in_s = (src_l >= 0) & (src_l < band_size)
        ds = ds.at[jnp.where(in_s, src_l, band_size)].add(
            d_src_x, mode="drop"
        )
        w_context = w_context.at[jnp.where(in_s, n_pad, src_x)].add(
            d_src_x, mode="drop"
        )

    w_context = jax.lax.dynamic_update_slice(
        w_context, ds, (band_start, 0)
    )
    if shared_table:
        w_vertex = w_context
    elif src_banded:
        dsv = dsv.at[src_x].add(d_src_x, mode="promise_in_bounds")
        w_vertex = jax.lax.dynamic_update_slice(
            w_vertex, dsv, (src_band_start, 0)
        )
    else:
        w_vertex = w_vertex.at[src_x].add(
            d_src_x, mode="promise_in_bounds"
        )

    m = min(1024, B)
    eps = 1e-7
    ce = -jnp.log(s_pos_full[:m] + eps) - (k_equiv / Ks) * jnp.sum(
        jnp.log(1.0 - s_neg_full[:m] + eps), axis=-1
    )
    return w_vertex, w_context, jnp.mean(ce)


# --------------------------------------------------------------------- #
# Band-PERSISTENT block SGNS: the held-band superstep.
#
# The per-step banded path re-pays the band slice + write-back on EVERY
# micro-step even under hoisted draws. This block kernel receives S
# micro-batches that all share ONE (src band, dst band) stratum
# (BandedTables.draw_banded_block -- same per-sample law), slices both
# bands ONCE, scans the S updates against the carried band slices, and
# writes back ONCE: band copy traffic drops by the hold factor S.
#
# Deviation vs S independent sgns_shared_negs_step_banded calls (both
# documented, quality-gated at the 40M AUC budget):
#   - negatives falling OUTSIDE the bands read the block-start table
#     snapshot and their updates apply once at block end (within-block
#     staleness of <= S steps on ~S*Ks rows out of n); IN-band rows
#     (positives, sources, in-band negatives) stay exactly as fresh as
#     the per-step path via the scanned band carry.
# --------------------------------------------------------------------- #
def sgns_banded_block(
    w_vertex: jnp.ndarray,  # (Np, D) order-2 vertex table
    w_context: jnp.ndarray,  # (Np, D), Np padded to a band multiple
    src_band_start: jnp.ndarray,  # () int32 -- all src in this band
    band_start: jnp.ndarray,  # () int32 -- all pos in this band
    band_size: int,
    src: jnp.ndarray,  # (S, B) global vids, repeat layout if grouped
    pos: jnp.ndarray,  # (S, B) global vids inside the dst band
    negs: jnp.ndarray,  # (S, Ks) global shared negative pools
    alphas: jnp.ndarray,  # (S,) per-micro-step decayed learning rates
    k_equiv: int = 5,
    src_group: int = 1,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    S, Ks = negs.shape
    B = src.shape[1]
    D = w_context.shape[1]
    n_pad = w_context.shape[0]
    G = src_group

    ds = jax.lax.dynamic_slice(w_context, (band_start, 0), (band_size, D))
    dsv = jax.lax.dynamic_slice(
        w_vertex, (src_band_start, 0), (band_size, D)
    )
    pos_l = pos - band_start
    src_l = src - src_band_start
    negs_l = negs - band_start
    in_b = (negs_l >= 0) & (negs_l < band_size)
    # out-of-band negative rows: one stale gather at block start (their
    # per-step updates are Ks tiny rows; freshness deferred to block end)
    cn_out = w_context.at[negs.reshape(-1)].get(
        mode="promise_in_bounds"
    ).reshape(S, Ks, D)
    dot = partial(jnp.dot, precision=SGNS_PRECISION,
                  preferred_element_type=jnp.float32)

    def body(carry, x):
        ds, dsv = carry
        src_l, pos_l, negs_l, in_b, cn_out, alpha = x
        if G > 1:
            src_small = src_l[::G]
            v = jnp.repeat(
                dsv.at[src_small].get(mode="promise_in_bounds"), G, axis=0
            )
        else:
            v = dsv.at[src_l].get(mode="promise_in_bounds")
        cp = ds.at[pos_l].get(mode="promise_in_bounds")
        cn_in = ds.at[
            jnp.where(in_b, negs_l, 0)
        ].get(mode="promise_in_bounds")
        cn = jnp.where(in_b[:, None], cn_in, cn_out)

        s_pos = jax.nn.sigmoid(jnp.einsum("bd,bd->b", v, cp))
        s_neg = jax.nn.sigmoid(dot(v, cn.T))
        g_pos = (1.0 - s_pos) * alpha
        g_neg = (0.0 - s_neg) * (alpha * (k_equiv / Ks))
        d_src = g_pos[:, None] * cp + dot(g_neg, cn)
        d_pos = g_pos[:, None] * v
        d_neg = dot(g_neg.T, v)

        ds = ds.at[pos_l].add(d_pos, mode="promise_in_bounds")
        ds = ds.at[jnp.where(in_b, negs_l, band_size)].add(
            d_neg, mode="drop"
        )
        if G > 1:
            dsv = dsv.at[src_small].add(
                d_src.reshape(B // G, G, D).sum(axis=1),
                mode="promise_in_bounds",
            )
        else:
            dsv = dsv.at[src_l].add(d_src, mode="promise_in_bounds")
        m = min(1024, B)
        eps = 1e-7
        ce = -jnp.log(s_pos[:m] + eps) - (k_equiv / Ks) * jnp.sum(
            jnp.log(1.0 - s_neg[:m] + eps), axis=-1
        )
        return (ds, dsv), (d_neg, jnp.mean(ce))

    (ds, dsv), (d_neg_all, losses) = jax.lax.scan(
        body, (ds, dsv), (src_l, pos_l, negs_l, in_b, cn_out, alphas)
    )

    w_context = jax.lax.dynamic_update_slice(w_context, ds, (band_start, 0))
    w_vertex = jax.lax.dynamic_update_slice(
        w_vertex, dsv, (src_band_start, 0)
    )
    # out-of-band negative updates, applied once at block end (in-band
    # ones already accumulated into ds inside the scan)
    w_context = w_context.at[
        jnp.where(in_b, n_pad, negs).reshape(-1)
    ].add(d_neg_all.reshape(S * Ks, D), mode="drop")
    return w_vertex, w_context, jnp.mean(losses)
