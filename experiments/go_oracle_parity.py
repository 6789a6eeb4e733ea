"""Reference-semantics oracle arms for the Go-only model families.

No Go toolchain exists in this image (VERDICT r2 "Missing #1"), so —
following the pattern of experiments/sasrec_eval.py — each Go-only model
gets a faithful sequential NumPy arm implementing the reference's exact
update semantics (per-sample hogwild-style writes, same init laws, same
negative laws, same schedules), and we run matched-budget head-to-heads
against our implementations with ONE shared eval per family.

Oracle provenance (semantics transcribed, not code):
  transe  /root/reference/internal/models/transe/transe.go:102-121 (score),
          :180-232 (train loop, corrupt head-or-tail, epoch renorm),
          :235-284 (manual gradient: raw h+r-t for L2, sign for L1)
  rotate  rotate.go:46-113 (phase init, ||h o r - t||), :180-250
          (self-adversarial weight exp(-negScore/T), normalized grad,
          conj-rotation chain rule, relation renorm per epoch)
  complex complex.go:85-117 (trilinear score, entity renorm), :120-156
          (analytic gradients), :240-252 (margin on neg-pos, both
          triples updated on violation)
  sne     sne.go:107-319 (epoch = all pos edges then all neg edges,
          shuffled; sigmoid pulls for +, beta-weighted pushes for -,
          uniform-vertex negative sampling with skip rules)
  ctdne   ctdne.go:100-211 (per-node time-increasing walk from a random
          start time, activity^0.75 negative table, skip-gram)
  metapath2vec  metapath2vec.go:106-316 (per-node metapath walk,
          uniform^0.75 negatives, skip-gram)
  shared  pkg/pronet/optimizer.go:8-58 (UpdatePair: SGNS, deferred
          vertex write), pronet.go:90-109 (1000-bin sigmoid LUT over
          [-8, 8]), pkg/temporal/temporal_graph.go:225-251,
          pkg/hetero/hetero_graph.go:221-257, pronet.go:310-333
          (SkipGrams WITHOUT window shrink)

Run:  python experiments/go_oracle_parity.py [transe rotate complex sne
      ctdne metapath2vec]   (ours on the GPU, oracles on host CPU)
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, "/root/repo")

if os.environ.get("ORACLE_CPU", "1") != "0":
    # The matched-budget QUALITY comparison doesn't need accelerator
    # speed, and keeping these arms on the host CPU leaves the card to
    # benchmarks.
    import jax

    jax.config.update("jax_platforms", "cpu")

DIM = 32
SEED = 5


# ===================================================================== #
# shared: Go fastSigmoid LUT (pronet.go:90-109 / proNet.cpp:52-71)
# ===================================================================== #
_SIG_TABLE = 1.0 / (1.0 + np.exp(-(np.arange(1000) / 999.0 * 16.0 - 8.0)))


def fast_sigmoid(x: float) -> float:
    if x > 8.0:
        return 1.0
    if x < -8.0:
        return 0.0
    return _SIG_TABLE[int((x + 8.0) / 16.0 * 999.0)]


# ===================================================================== #
# datasets (seeded synthetics shaped for each family's structure)
# ===================================================================== #
def make_kg(path, n_clusters=12, per=100, n_rel=6, triples_per_rel=3500):
    """Entities in clusters; relation r links cluster c -> (c+r+1)%12.
    A model that learns the relational geometry ranks true tails high."""
    rng = np.random.default_rng(SEED)
    lines = []
    for r in range(n_rel):
        h = rng.integers(0, n_clusters * per, triples_per_rel)
        hc = h // per
        tc = (hc + r + 1) % n_clusters
        t = tc * per + rng.integers(0, per, triples_per_rel)
        for hh, tt in zip(h, t):
            lines.append(f"e{hh} r{r} e{tt}\n")
    with open(path, "w") as f:
        f.writelines(lines)
    return path


def make_signed(path, camps=3, per=400, pos_e=24000, neg_e=8000):
    rng = np.random.default_rng(SEED)
    n = camps * per
    lines = []
    for _ in range(pos_e):
        c = rng.integers(0, camps)
        a, b = c * per + rng.integers(0, per, 2)
        if a != b:
            lines.append(f"v{a} v{b} +1\n")
    for _ in range(neg_e):
        c1 = rng.integers(0, camps)
        c2 = (c1 + 1 + rng.integers(0, camps - 1)) % camps
        a = c1 * per + rng.integers(0, per)
        b = c2 * per + rng.integers(0, per)
        lines.append(f"v{a} v{b} -1\n")
    with open(path, "w") as f:
        f.writelines(lines)
    return path


def make_temporal(path, comms=4, per=150, edges=20000, horizon=100.0):
    """Intra-community edges spread over [0, horizon); walks that follow
    time stay inside a community."""
    rng = np.random.default_rng(SEED)
    lines = []
    for _ in range(edges):
        c = rng.integers(0, comms)
        a, b = c * per + rng.integers(0, per, 2)
        if a == b:
            continue
        t = rng.random() * horizon
        lines.append(f"n{a} n{b} {t:.3f}\n")
    with open(path, "w") as f:
        f.writelines(lines)
    return path


def make_hetero(path, topics=6, authors_pt=80, papers_pt=120, venues_pt=2):
    """Author-paper-venue per topic; APA walks stay intra-topic."""
    rng = np.random.default_rng(SEED)
    lines = []
    for c in range(topics):
        for a in range(authors_pt):
            an = f"a{c * authors_pt + a}"
            for p in rng.choice(papers_pt, 5, replace=False):
                lines.append(
                    f"{an} author p{c * papers_pt + p} paper writes\n"
                )
        for p in range(papers_pt):
            v = c * venues_pt + rng.integers(0, venues_pt)
            lines.append(
                f"p{c * papers_pt + p} paper v{v} venue published_at\n"
            )
    with open(path, "w") as f:
        f.writelines(lines)
    return path


# ===================================================================== #
# shared evals
# ===================================================================== #
def kg_rank_eval(score_batch, heads, rels, tails, n_entities, n_neg=50,
                 n_test=1000, seed=0):
    """MRR + hits@3 of the true triple vs n_neg uniform corrupted heads.
    score_batch(h, r, t) -> HIGHER = better (arm adapts sign)."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(heads), min(n_test, len(heads)), replace=False)
    h, r, t = heads[idx], rels[idx], tails[idx]
    correct = score_batch(h, r, t)
    better = np.zeros(len(idx))
    for _ in range(n_neg):
        nh = rng.integers(0, n_entities, len(idx))
        better += (correct > score_batch(nh, r, t)).astype(np.float64)
    rank = n_neg - better + 1
    return float((1.0 / rank).mean()), float((rank <= 3).mean())


def auc(pos, neg):
    pos, neg = np.asarray(pos), np.asarray(neg)
    return float((pos[:, None] > neg[None, :]).mean()
                 + 0.5 * (pos[:, None] == neg[None, :]).mean())


def community_auc_emb(emb, labels, n_pairs=20000, seed=0):
    x = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-12)
    rng = np.random.default_rng(seed)
    a = rng.integers(0, len(x), n_pairs * 3)
    b = rng.integers(0, len(x), n_pairs * 3)
    same = labels[a] == labels[b]
    s = (x[a] * x[b]).sum(1)
    return auc(s[same][:n_pairs], s[~same][:n_pairs][:2000])


# ===================================================================== #
# KG oracles (sequential per-triple SGD, float64)
# ===================================================================== #
def _kg_arrays(path):
    from smore_tpu.graph.knowledge import KnowledgeGraph
    kg = KnowledgeGraph.load_triples(path)
    return kg


def _corrupt(kg, rng, h, r, t):
    """Per-relation entity pool corruption (knowledge_graph.go:185-212)."""
    pool = kg.rel_entities[kg.rel_indptr[r]:kg.rel_indptr[r + 1]]
    c = pool[rng.integers(0, len(pool))]
    if rng.random() < 0.5:
        return c, t
    return h, c


def oracle_transe(kg, epochs, alpha, margin=1.0, norm=2):
    rng = np.random.default_rng(SEED + 1)
    n, m = kg.n_entities, kg.n_relations
    ent = rng.uniform(-6 / np.sqrt(DIM), 6 / np.sqrt(DIM), (n, DIM))
    ent /= np.linalg.norm(ent, axis=1, keepdims=True)
    rel = rng.uniform(-6 / np.sqrt(DIM), 6 / np.sqrt(DIM), (m, DIM))
    H, R, T = kg.heads, kg.relations, kg.tails
    for _ in range(epochs):
        for i in rng.permutation(len(H)):
            h, r, t = H[i], R[i], T[i]
            nh, nt = _corrupt(kg, rng, h, r, t)
            pd = ent[h] + rel[r] - ent[t]
            nd = ent[nh] + rel[r] - ent[nt]
            ps = np.abs(pd).sum() if norm == 1 else np.sqrt(pd @ pd)
            ns = np.abs(nd).sum() if norm == 1 else np.sqrt(nd @ nd)
            if margin + ps - ns > 0:
                g_p = np.sign(pd) if norm == 1 else pd  # transe.go:262-270
                g_n = np.sign(nd) if norm == 1 else nd
                ent[h] -= alpha * g_p
                rel[r] -= alpha * g_p
                ent[t] += alpha * g_p
                ent[nh] += alpha * g_n
                rel[r] += alpha * g_n
                ent[nt] -= alpha * g_n
        ent /= np.maximum(np.linalg.norm(ent, axis=1, keepdims=True), 1e-12)
    return ent, rel


def oracle_rotate(kg, epochs, alpha, margin=6.0, temp=1.0):
    rng = np.random.default_rng(SEED + 2)
    n, m = kg.n_entities, kg.n_relations
    cd = DIM // 2
    phase = rng.random((n, cd)) * 2 * np.pi
    mag = (rng.random((n, cd)) * 0.5 + 0.5) / cd
    ent = mag * np.exp(1j * phase)  # rotate.go:70-82
    rel = np.exp(1j * rng.random((m, cd)) * 2 * np.pi)
    H, R, T = kg.heads, kg.relations, kg.tails

    def score(h, r, t):
        d = ent[h] * rel[r] - ent[t]
        return np.sqrt((d.real ** 2 + d.imag ** 2).sum())

    for _ in range(epochs):
        for i in rng.permutation(len(H)):
            h, r, t = H[i], R[i], T[i]
            nh, nt = _corrupt(kg, rng, h, r, t)
            ps, ns = score(h, r, t), score(nh, R[i], nt)
            w = np.exp(-ns / temp) if temp > 0 else 1.0
            if margin + ps - ns > 0:
                for (hh, tt, lr) in ((h, t, alpha), (nh, nt, -alpha * w)):
                    d = ent[hh] * rel[r] - ent[tt]
                    nrm = np.abs(d)
                    g = np.where(nrm > 1e-10, d / np.maximum(nrm, 1e-10), 0)
                    ent[hh] -= lr * g * np.conj(rel[r])
                    rel[r] -= lr * g * np.conj(ent[hh])
                    ent[tt] += lr * g
        rel /= np.maximum(np.abs(rel), 1e-12)  # unit rotations per epoch
    return ent, rel


def oracle_complex(kg, epochs, alpha, margin=1.0, negs=10):
    # complex.go:41-84: entities AND relations init uniform(-0.5,0.5)/dim
    # per real/imag component; entities normalized to unit length at init
    # (normalizeEntity), relations NOT normalized. (The round-3 oracle's
    # 6/sqrt(d) init gave relations ~30x the reference's magnitude --
    # saturating the trilinear margin loss -- and refreshed the positive
    # score inside the negative loop, which complex.go:224 does not:
    # posScore is computed once per triple and stays stale across all
    # negativeSamples corruptions.)
    #
    # ROUND-4 ROOT CAUSE (VERDICT r3 item 4): re-run with the corrected
    # init + stale posScore across a (dim, lr) sweep -- cd 8/50, lr
    # 0.01/0.001, up to 12 epochs with per-epoch eval -- the reference
    # semantics PEAK at MRR ~0.11 in the first 2-4 epochs and then
    # DEGRADE. Mechanism (reference-semantics defect, not an oracle
    # bug): complex.go applies no regularization to RELATION embeddings
    # (rotate.go:84-93 by contrast projects relations to unit modulus
    # every epoch), so under the always-violated margin loss |rel| grows
    # without bound (measured: 0.37 -> 9.2 over 12 epochs at lr=0.01);
    # entity gradient magnitude scales with |rel|, so the per-update
    # angular moves of the unit-renormed entities grow until updates are
    # a random walk. Ablating the per-update entity renorm (per-epoch or
    # none) diverges to NaN -- the renorm is the only stabilizer, and it
    # cannot bound the relations. Ours (batched margin loss, per-step
    # renorm, bounded effective step) reaches MRR 0.64 on the same data;
    # the "both arms > 0.3" bar is unreachable for the faithful oracle.
    rng = np.random.default_rng(SEED + 3)
    n, m = kg.n_entities, kg.n_relations
    cd = DIM // 2
    s = 0.5 / cd
    ent = rng.uniform(-s, s, (n, cd)) + 1j * rng.uniform(-s, s, (n, cd))
    ent /= np.maximum(
        np.sqrt((ent.real ** 2 + ent.imag ** 2).sum(1, keepdims=True)),
        1e-12,
    )
    rel = rng.uniform(-s, s, (m, cd)) + 1j * rng.uniform(-s, s, (m, cd))
    H, R, T = kg.heads, kg.relations, kg.tails

    def score(h, r, t):
        return (ent[h] * rel[r] * np.conj(ent[t])).real.sum()

    def renorm(e):
        nrm = np.sqrt((ent[e].real ** 2 + ent[e].imag ** 2).sum())
        if nrm > 0:
            ent[e] /= nrm

    for _ in range(epochs):
        for i in rng.permutation(len(H)):
            h, r, t = H[i], R[i], T[i]
            ps = score(h, r, t)  # stale across the negative loop
            # complex.go:225-252: negativeSamples (CLI default 10) fresh
            # corruptions per positive, both triples updated on violation
            for _ in range(negs):
                nh, nt = _corrupt(kg, rng, h, r, t)
                ns = score(nh, r, nt)
                if margin + ns - ps > 0:
                    for (hh, tt, sgn) in ((h, t, -1.0), (nh, nt, 1.0)):
                        gh = rel[r] * np.conj(ent[tt])
                        gr = ent[hh] * np.conj(ent[tt])
                        gt = np.conj(ent[hh] * rel[r])
                        ent[hh] -= alpha * sgn * gh
                        rel[r] -= alpha * sgn * gr
                        ent[tt] -= alpha * sgn * gt
                        renorm(hh)
                        renorm(tt)
    return ent, rel


# ===================================================================== #
# SNE oracle
# ===================================================================== #
def oracle_sne(net, epochs, samples_per_edge, alpha, beta, negs):
    rng = np.random.default_rng(SEED + 4)
    n = net.n_vertices
    src_t = (rng.random((n, DIM)) - 0.5) / DIM
    tgt_t = (rng.random((n, DIM)) - 0.5) / DIM
    pos = np.stack([net.pos_src, net.pos_dst], 1)
    neg = np.stack([net.neg_src, net.neg_dst], 1)
    neg_sets = {}
    for a, b in neg:
        neg_sets.setdefault(a, set()).add(b)
    total = epochs * samples_per_edge * (len(pos) + len(neg))
    count = 0
    cur = alpha
    for _ in range(epochs):
        for positive, edges in ((True, pos), (False, neg)):
            for i in rng.permutation(len(edges)):
                f, t = edges[i]
                for _ in range(samples_per_edge):
                    if positive:  # sne.go:238-278
                        g = cur * (1.0 - fast_sigmoid(src_t[f] @ tgt_t[t]))
                        src_t[f], tgt_t[t] = (
                            src_t[f] + g * tgt_t[t],
                            tgt_t[t] + g * src_t[f],
                        )
                        for _ in range(negs):
                            v = rng.integers(0, n)
                            if v == t:
                                continue
                            gn = cur * (0.0 - fast_sigmoid(
                                src_t[f] @ tgt_t[v]))
                            src_t[f], tgt_t[v] = (
                                src_t[f] + gn * tgt_t[v],
                                tgt_t[v] + gn * src_t[f],
                            )
                    else:  # sne.go:281-319
                        g = cur * beta * (
                            0.0 - fast_sigmoid(src_t[f] @ tgt_t[t]))
                        src_t[f], tgt_t[t] = (
                            src_t[f] + g * tgt_t[t],
                            tgt_t[t] + g * src_t[f],
                        )
                        for _ in range(negs):
                            v = rng.integers(0, n)
                            if v == t or v in neg_sets.get(f, ()):
                                continue
                            gn = cur * beta * (1.0 - fast_sigmoid(
                                src_t[f] @ tgt_t[v]))
                            src_t[f], tgt_t[v] = (
                                src_t[f] + gn * tgt_t[v],
                                tgt_t[v] + gn * src_t[f],
                            )
                    count += 1
                    if count % 10000 == 0:
                        cur = max(alpha * (1 - count / total), alpha * 1e-4)
    return src_t, tgt_t


# ===================================================================== #
# walk-family oracles (skip-gram WITHOUT window shrink, UpdatePair SGNS)
# ===================================================================== #
def _update_pair(wv, wc, v, c, negs_draw, n_negs, alpha):
    """pkg/pronet/optimizer.go:8-58 -- deferred vertex/context write."""
    vg = np.zeros(wv.shape[1])
    cg = np.zeros(wv.shape[1])
    g = alpha * (1.0 - fast_sigmoid(wv[v] @ wc[c]))
    vg += g * wc[c]
    cg += g * wv[v]
    for _ in range(n_negs):
        s = negs_draw()
        if s == c:
            continue
        gn = alpha * (0.0 - fast_sigmoid(wv[v] @ wc[s]))
        vg += gn * wc[s]
        wc[s] += gn * wv[v]
    wv[v] += vg
    wc[c] += cg


def _skipgrams(walk, window):
    out = []
    for i in range(len(walk)):
        for j in range(max(0, i - window), min(len(walk), i + window + 1)):
            if i != j:
                out.append((walk[i], walk[j]))
    return out


def _alias_draw_factory(mass, power, rng):
    from smore_tpu.sampling.alias import build_alias
    p, a = build_alias(np.asarray(mass, np.float64), power=power)
    a = np.where(a < 0, np.arange(len(mass)), a)

    def draw():
        i = rng.integers(0, len(mass))
        return i if rng.random() < p[i] else int(a[i])

    return draw


def oracle_ctdne(tg, walk_times, walk_steps, window, negs, alpha,
                 time_window):
    rng = np.random.default_rng(SEED + 5)
    n = tg.n_vertices
    wv = (rng.random((n, DIM)) - 0.5) / DIM
    wc = np.zeros((n, DIM))
    activity = np.maximum(np.diff(tg.indptr), 1).astype(np.float64)
    neg_draw = _alias_draw_factory(activity, 0.75, rng)
    total = walk_times * n
    count = 0
    cur = alpha
    for _ in range(walk_times):
        for v in rng.permutation(n):
            lo, hi = tg.indptr[v], tg.indptr[v + 1]
            count += 1
            if hi == lo:
                continue
            tmin, tmax = tg.active_min[v], tg.active_max[v]
            t0 = tmin + rng.random() * max(tmax - tmin, time_window)
            walk, cur_v, cur_t = [v], v, t0
            for _ in range(walk_steps):
                # time-increasing neighbor in (cur_t, cur_t+window]
                lo2, hi2 = tg.indptr[cur_v], tg.indptr[cur_v + 1]
                ts = tg.edge_ts[lo2:hi2]
                ok = np.flatnonzero(
                    (ts > cur_t) & (ts <= cur_t + time_window))
                if len(ok) == 0:
                    break
                j = ok[rng.integers(0, len(ok))]
                cur_v = int(tg.edge_dst[lo2 + j])
                cur_t = float(ts[j])
                walk.append(cur_v)
            for a, b in _skipgrams(walk, window):
                _update_pair(wv, wc, a, b, neg_draw, negs, cur)
            if count % 1000 == 0:
                cur = max(alpha * (1 - count / total), alpha * 1e-4)
    return wv


def oracle_metapath2vec(hg, meta_path, walk_times, walk_steps, window,
                        negs, alpha):
    rng = np.random.default_rng(SEED + 6)
    n = hg.n_vertices
    wv = (rng.random((n, DIM)) - 0.5) / DIM
    wc = np.zeros((n, DIM))
    neg_draw = _alias_draw_factory(np.ones(n), 0.75, rng)
    total = walk_times * n
    count = 0
    cur = alpha
    path_ids = [hg.type2id[t] for t in meta_path]
    for _ in range(walk_times):
        for v in rng.permutation(n):
            count += 1
            walk, cur_v, pi = [v], v, 0
            for _ in range(walk_steps):
                if hg.node_type[cur_v] != path_ids[pi % len(path_ids)]:
                    break
                want = meta_path[(pi + 1) % len(path_ids)]
                nbrs = hg.neighbors_by_type(cur_v, want)
                if len(nbrs) == 0:
                    break
                cur_v = int(nbrs[rng.integers(0, len(nbrs))])
                walk.append(cur_v)
                pi += 1
            if len(walk) > 1:
                for a, b in _skipgrams(walk, window):
                    _update_pair(wv, wc, a, b, neg_draw, negs, cur)
            if count % 1000 == 0:
                cur = max(alpha * (1 - count / total), alpha * 1e-4)
    return wv


# ===================================================================== #
# round-4 additions (VERDICT r3 item 8): JODIE, HAN, CPR, TPR oracles
# ===================================================================== #
def make_interactions(path, users=40, items=60, clusters=4, events=8000):
    """Users repeatedly interact with their own cluster's items over
    increasing time (format: user item timestamp)."""
    rng = np.random.default_rng(SEED)
    t = 0.0
    lines = []
    for _ in range(events):
        u = int(rng.integers(0, users))
        own = np.arange(u % clusters, items, clusters)
        i = int(own[rng.integers(0, len(own))])
        t += float(rng.random())
        lines.append(f"u{u} i{i} {t:.3f}\n")
    with open(path, "w") as f:
        f.writelines(lines)
    return path


def _jodie_eval(ue, ie, user_ids, item_ids, n_items, tail=1000):
    """jodie.go:356-399: pairwise accuracy pos > random-neg over the
    last <= tail (and <= 20%) interactions; identical fixed negative
    draws for both arms."""
    n = min(tail, max(1, len(user_ids) // 5))
    u = np.asarray(user_ids[-n:])
    i = np.asarray(item_ids[-n:])
    rng = np.random.default_rng(0)
    neg = rng.integers(0, n_items, n)
    s_pos = np.einsum("nd,nd->n", ue[u], ie[i])
    s_neg = np.einsum("nd,nd->n", ue[u], ie[neg])
    return float((s_pos > s_neg).mean())


def oracle_jodie(ig, epochs, lr, dim=DIM):
    """jodie.go:52-296 + pkg/rnn/rnn.go:20-81, sequential NumPy.

    Per epoch: dynamics reset to statics; chronological scan; user then
    item RNN-gated EMA updates (the item update reads the POST-update
    user row, jodie.go:269-275); statics EMA at 0.1*lr. The RNN cells'
    weights are fixed after init (never trained in the reference)."""
    rng = np.random.default_rng(SEED + 7)
    nu, ni = ig.n_users, ig.n_items
    u_static = (rng.random((nu, dim)) - 0.5) / dim
    i_static = (rng.random((ni, dim)) - 0.5) / dim
    in_dim = dim + 1  # no features in this dataset

    def cell():
        s = 1.0 / np.sqrt(dim)
        return ((rng.random((dim, dim)) * 2 - 1) * s,
                (rng.random((dim, in_dim)) * 2 - 1) * s,
                np.zeros(dim))

    uWh, uWx, uB = cell()
    iWh, iWx, iB = cell()
    ts = np.asarray(ig.timestamps)
    uu = np.asarray(ig.user_ids)
    ii = np.asarray(ig.item_ids)
    tmin = float(ts.min()) if len(ts) else 0.0

    for _ in range(epochs):
        u_dyn, i_dyn = u_static.copy(), i_static.copy()
        u_last = np.full(nu, tmin)
        i_last = np.full(ni, tmin)
        for k in range(len(uu)):
            u, i, t = int(uu[k]), int(ii[k]), float(ts[k])
            # user update (input = [item_emb, dt/100])
            x = np.concatenate([i_dyn[i], [(t - u_last[u]) / 100.0]])
            new_u = np.tanh(uWh @ u_dyn[u] + uWx @ x + uB)
            u_dyn[u] = (1 - lr) * u_dyn[u] + lr * new_u
            u_last[u] = t
            # item update reads the UPDATED user row (jodie.go:269)
            x = np.concatenate([u_dyn[u], [(t - i_last[i]) / 100.0]])
            new_i = np.tanh(iWh @ i_dyn[i] + iWx @ x + iB)
            i_dyn[i] = (1 - lr) * i_dyn[i] + lr * new_i
            i_last[i] = t
            # static EMA
            slr = lr * 0.1
            u_static[u] += slr * (u_dyn[u] - u_static[u])
            i_static[i] += slr * (i_dyn[i] - i_static[i])
    return u_static, i_static


def run_jodie():
    from smore_tpu.graph.bipartite import InteractionGraph
    from smore_tpu.models.jodie import JODIE

    path = make_interactions("/tmp/oracle_interactions.txt")
    ig = InteractionGraph.load_interactions(path)
    epochs, lr = 8, 0.05
    print(f"[jodie] {ig.n_interactions} interactions, "
          f"{ig.n_users}x{ig.n_items}", flush=True)

    t0 = time.time()
    oue, oie = oracle_jodie(ig, epochs, lr)
    t_oracle = time.time() - t0
    o_acc = _jodie_eval(oue, oie, ig.user_ids, ig.item_ids, ig.n_items)

    t0 = time.time()
    m = JODIE(ig, seed=0)
    m.init(dim=DIM)
    m.train(epochs=epochs, learning_rate=lr, verbose=False)
    t_ours = time.time() - t0
    u_acc = _jodie_eval(
        np.asarray(m.state["user_static"]),
        np.asarray(m.state["item_static"]),
        ig.user_ids, ig.item_ids, ig.n_items,
    )
    # the reference NEVER backprops its BCE loss (jodie.go:247-262 logs
    # it; embeddings move only through the fixed random RNN gates), so
    # near-chance accuracy IS the reference behavior -- both faithful
    # arms land there. bce_lr is our documented upgrade: the same BCE
    # signal actually trains the tables.
    m2 = JODIE(ig, seed=0)
    m2.init(dim=DIM)
    m2.train(epochs=epochs, learning_rate=lr, bce_lr=0.2, verbose=False)
    up_acc = _jodie_eval(
        np.asarray(m2.state["user_static"]),
        np.asarray(m2.state["item_static"]),
        ig.user_ids, ig.item_ids, ig.n_items,
    )
    print(f"{'jodie':14s} ours acc={u_acc:.4f} ({t_ours:.0f}s) | "
          f"oracle {o_acc:.4f} ({t_oracle:.0f}s) | "
          f"ours+bce {up_acc:.4f} (upgrade)", flush=True)
    return "jodie", u_acc, o_acc, up_acc, None


def oracle_han(hg, meta_paths, walk_times, walk_steps, epochs, lr,
               dim=DIM):
    """han.go:76-383, sequential NumPy: per epoch per (shuffled) node,
    per meta-path: walk_times MetaPathWalks contribute their END node as
    a neighbor; node-level attention a^T(Wh_i + Wh_j) with LeakyReLU +
    softmax; aggregate transformed neighbors; semantic attention
    q^T tanh(z_p) + softmax across paths; emb += lr * final; then
    L2-normalize the node row. Transforms W_p are near-identity at init
    and NEVER trained (no gradient reaches them in the reference)."""
    rng = np.random.default_rng(SEED + 8)
    n = hg.n_vertices
    emb = (rng.random((n, dim)) - 0.5) / dim
    P = len(meta_paths)
    W = np.empty((P, dim, dim))
    for p in range(P):
        W[p] = (rng.random((dim, dim)) - 0.5) / dim
        np.fill_diagonal(W[p], 1.0)
    attn = (rng.random((P, dim)) - 0.5) / dim
    sem = (rng.random(dim) - 0.5) / dim
    path_ids = [[hg.type2id[t] for t in mp] for mp in meta_paths]

    for _ in range(epochs):
        for v in rng.permutation(n):
            z = np.zeros((P, dim))
            have = np.zeros(P, dtype=bool)
            for p, mp in enumerate(meta_paths):
                nbrs = []
                for _w in range(walk_times):
                    cur, pi = v, 0
                    walk = [v]
                    while len(walk) < walk_steps + 1:
                        if hg.node_type[cur] != path_ids[p][
                                pi % len(path_ids[p])]:
                            break
                        want = mp[(pi + 1) % len(mp)]
                        cand = hg.neighbors_by_type(cur, want)
                        if len(cand) == 0:
                            break
                        cur = int(cand[rng.integers(0, len(cand))])
                        walk.append(cur)
                        pi += 1
                    if len(walk) > 1:
                        nbrs.append(walk[-1])
                if not nbrs:
                    continue
                have[p] = True
                hv = W[p] @ emb[v]
                hn = emb[np.asarray(nbrs)] @ W[p].T  # (k, dim)
                score = hn @ attn[p] + hv @ attn[p]
                score = np.where(score < 0, 0.01 * score, score)
                e = np.exp(score)
                a = e / e.sum()
                z[p] = a @ hn
            if not have.any():
                continue
            s = np.array([
                sem @ np.tanh(z[p]) if have[p] else -np.inf
                for p in range(P)
            ])
            # han.go:218-251: softmax over paths (exp(-inf) = 0 weight
            # matches the reference's skip of nil embeddings)
            e = np.exp(s - s[have].max())
            e[~have] = 0.0
            a = e / e.sum()
            final = a @ z
            emb[v] += lr * final
            nrm = np.linalg.norm(emb[v])
            if nrm > 0:
                emb[v] /= nrm
    return emb


def run_han():
    from smore_tpu.graph.hetero import HeteroGraph
    from smore_tpu.models.han import HAN

    path = make_hetero("/tmp/oracle_hetero.txt")
    hg = HeteroGraph.load_edge_list(path, undirected=True)
    mps = [["author", "paper", "author"],
           ["author", "paper", "venue", "paper", "author"]]
    # At the reference DEFAULTS (epochs=10, lr=0.01) the per-epoch
    # drift lr * |final| ~ 0.01 against a unit-normalized random init,
    # so BOTH arms stay init-dominated (~0.51 AUC -- behavioral parity,
    # measured round 4). epochs=40 / lr=0.05 gives the attention
    # propagation enough mass to expose the actual dynamics head-to-head.
    wt, ws, epochs, lr = 5, 4, 40, 0.05
    labels = np.zeros(hg.n_vertices, dtype=np.int64)
    author_rows = []
    for vid, nm in enumerate(hg.names):
        if nm.startswith("a"):
            labels[vid] = int(nm[1:]) // 80
            author_rows.append(vid)
    author_rows = np.asarray(author_rows)
    print(f"[han] {hg.n_vertices} nodes, {len(mps)} meta-paths",
          flush=True)

    t0 = time.time()
    o_emb = oracle_han(hg, mps, wt, ws, epochs, lr)
    t_oracle = time.time() - t0
    o_auc = community_auc_emb(o_emb[author_rows], labels[author_rows])

    t0 = time.time()
    m = HAN(hg, seed=0)
    for mp in mps:
        m.add_meta_path(mp)
    m.init(dim=DIM, learning_rate=lr)
    m.train(walk_times=wt, walk_steps=ws, epochs=epochs, verbose=False)
    t_ours = time.time() - t0
    u_auc = community_auc_emb(
        np.asarray(m.state["embed"])[author_rows], labels[author_rows])
    print(f"{'han':14s} ours comm-AUC={u_auc:.4f} ({t_ours:.0f}s) | "
          f"oracle {o_auc:.4f} ({t_oracle:.0f}s)", flush=True)
    return "han", u_auc, o_auc, None, None


def make_two_domains(t_path, s_path, users=300, items_t=200, items_s=200,
                     clusters=6, per_user=12):
    """Shared users, cluster-consistent tastes in BOTH domains; the last
    2 target interactions per user are held out for eval."""
    rng = np.random.default_rng(SEED)
    test_u, test_i = [], []
    with open(t_path, "w") as ft, open(s_path, "w") as fs:
        for u in range(users):
            c = u % clusters
            own_t = np.arange(c, items_t, clusters)
            own_s = np.arange(c, items_s, clusters)
            picks = rng.choice(own_t, min(per_user, len(own_t)),
                               replace=False)
            for i in picks[:-2]:
                ft.write(f"u{u} t{i} 1\n")
            test_u.extend([u] * 2)
            test_i.extend(picks[-2:].tolist())
            for i in rng.choice(own_s, min(per_user, len(own_s)),
                                replace=False):
                fs.write(f"u{u} s{i} 1\n")
    return np.asarray(test_u), np.asarray(test_i)


def _go_pronet_arrays(path):
    """Adjacency + sampling masses per the Go pronet laws
    (pronet.go:223-249): source ~ out-degree (power 1), target ~ edge
    weight (linear scan), negative ~ (in+out degree)^0.75."""
    from smore_tpu.graph.graph import Graph

    g = Graph.load_edge_list(path, undirected=True)
    out_deg = np.zeros(g.n_vertices)
    np.add.at(out_deg, np.repeat(np.arange(g.n_vertices),
                                 np.diff(g.indptr)), g.weights)
    in_deg = np.zeros(g.n_vertices)
    np.add.at(in_deg, g.indices, g.weights)
    return g, out_deg, in_deg


def oracle_cpr(gt, gs, updates, alpha, user_reg=0.01, item_reg=0.01,
               margin=8.0, dim=DIM):
    """cpr.go:47-294, sequential NumPy. transformUser = mean(user row +
    owned target rows + owned source rows) (cpr.go:128-172); margin-BPR
    with sigmoid(margin - diff) gradient in the TARGET domain only (the
    Go Train only iterates target pairs; the source tables contribute
    through the aggregation)."""
    rng = np.random.default_rng(SEED + 9)
    g_t, out_t, in_t = gt
    g_s, out_s, in_s = gs
    n_t, n_s = g_t.n_vertices, g_s.n_vertices
    user = (rng.random((n_t, dim)) - 0.5) / dim
    tgt = (rng.random((n_t, dim)) - 0.5) / dim
    src = (rng.random((n_s, dim)) - 0.5) / dim
    # ownership lists (uid -> owned items), shared-user mapping by name
    s_of_t = np.array(
        [g_s.name2id.get(nm, -1) for nm in g_t.names], dtype=np.int64)
    src_draw = _alias_draw_factory(out_t, 1.0, rng)
    neg_draw = _alias_draw_factory(in_t + out_t, 0.75, rng)
    cur = alpha
    amin = alpha * 1e-4
    for k in range(updates):
        u = src_draw()
        lo, hi = g_t.indptr[u], g_t.indptr[u + 1]
        if hi == lo:
            continue
        w = g_t.weights[lo:hi]
        r = rng.random() * w.sum()
        pos = int(g_t.indices[lo + np.searchsorted(np.cumsum(w), r)])
        neg = neg_draw()
        # transformUser
        agg = user[u].copy()
        cnt = 1.0
        own_t = g_t.indices[lo:hi]
        agg += tgt[own_t].sum(0)
        cnt += len(own_t)
        us = s_of_t[u]
        if us >= 0:
            lo2, hi2 = g_s.indptr[us], g_s.indptr[us + 1]
            own_s = g_s.indices[lo2:hi2]
            agg += src[own_s].sum(0)
            cnt += len(own_s)
        uvec = agg / cnt
        diff = uvec @ tgt[pos] - uvec @ tgt[neg]
        if diff < margin:
            g = cur * fast_sigmoid(-(diff - margin))
            ug = g * (tgt[pos] - tgt[neg])
            user[u] += ug - cur * user_reg * user[u]
            pg = g * uvec
            tgt[pos] += pg - cur * item_reg * tgt[pos]
            tgt[neg] += -pg - cur * item_reg * tgt[neg]
        if (k + 1) % 10000 == 0:
            cur = max(alpha * (1 - (k + 1) / updates), amin)
    return user, tgt, src


def _cpr_eval(user, tgt, g_t, g_s, s_of_t, test_u_vid, test_i_vid):
    """AUC of transformed-user . target-item for held-out edges vs
    random items -- the SAME transformUser aggregation for both arms."""
    rng = np.random.default_rng(1)
    scores_p, scores_n = [], []
    for u, i in zip(test_u_vid, test_i_vid):
        lo, hi = g_t.indptr[u], g_t.indptr[u + 1]
        agg = user[u].copy()
        cnt = 1.0
        own_t = g_t.indices[lo:hi]
        agg += tgt[own_t].sum(0)
        cnt += len(own_t)
        us = s_of_t[u]
        if us >= 0:
            pass  # source half identical across arms; target-only eval
        uvec = agg / cnt
        scores_p.append(uvec @ tgt[i])
        scores_n.append(uvec @ tgt[rng.integers(0, tgt.shape[0])])
    sp = np.asarray(scores_p)
    sn = np.asarray(scores_n)
    return float((sp[:, None] > sn[None, :]).mean())


def run_cpr():
    from smore_tpu.models.cpr import CPR

    t_path, s_path = "/tmp/oracle_cpr_t.txt", "/tmp/oracle_cpr_s.txt"
    test_u, test_i = make_two_domains(t_path, s_path)
    gt = _go_pronet_arrays(t_path)
    gs = _go_pronet_arrays(s_path)
    g_t, g_s = gt[0], gs[0]
    s_of_t = np.array(
        [g_s.name2id.get(nm, -1) for nm in g_t.names], dtype=np.int64)
    test_u_vid = np.array([g_t.name2id[f"u{u}"] for u in test_u])
    test_i_vid = np.array([g_t.name2id[f"t{i}"] for i in test_i])
    updates, alpha = 600_000, 0.1
    print(f"[cpr] target {g_t.n_vertices} vids, source {g_s.n_vertices}",
          flush=True)

    t0 = time.time()
    ou, ot, _ = oracle_cpr(gt, gs, updates, alpha)
    t_oracle = time.time() - t0
    o_auc = _cpr_eval(ou, ot, g_t, g_s, s_of_t, test_u_vid, test_i_vid)

    t0 = time.time()
    m = CPR.load_domains(t_path, s_path, seed=0)
    m.init(dim=DIM)
    m.train(update_times=updates / 1e6, alpha=alpha, verbose=False)
    t_ours = time.time() - t0
    # map our state rows into the eval's (g_t, g_s) vid space by name
    mu = np.zeros((g_t.n_vertices, DIM))
    mt = np.zeros((g_t.n_vertices, DIM))
    for nm, vid in m.target.name2id.items():
        j = g_t.name2id.get(nm)
        if j is not None:
            mu[j] = np.asarray(m.state["user"])[vid]
            mt[j] = np.asarray(m.state["target"])[vid]
    u_auc = _cpr_eval(mu, mt, g_t, g_s, s_of_t, test_u_vid, test_i_vid)
    print(f"{'cpr':14s} ours AUC={u_auc:.4f} ({t_ours:.0f}s) | "
          f"oracle {o_auc:.4f} ({t_oracle:.0f}s)", flush=True)
    return "cpr", u_auc, o_auc, None, None


def make_text_rec(ui_path, iw_path, users=300, items=240, words=120,
                  clusters=6, per_user=12, words_per_item=5):
    """Clustered user-item edges + topic-consistent item-word edges;
    last 2 interactions per user held out."""
    rng = np.random.default_rng(SEED)
    test_u, test_i = [], []
    with open(ui_path, "w") as fu, open(iw_path, "w") as fw:
        for i in range(items):
            c = i % clusters
            own_w = np.arange(c, words, clusters)
            for w in rng.choice(own_w, min(words_per_item, len(own_w)),
                                replace=False):
                fw.write(f"i{i} w{w} 1\n")
        for u in range(users):
            c = u % clusters
            own = np.arange(c, items, clusters)
            picks = rng.choice(own, min(per_user, len(own)),
                               replace=False)
            for i in picks[:-2]:
                fu.write(f"u{u} i{i} 1\n")
            test_u.extend([u] * 2)
            test_i.extend(picks[-2:].tolist())
    return np.asarray(test_u), np.asarray(test_i)


def oracle_tpr(gui, giw, ui2iw, samples, alpha, lam=0.025, tw=0.5,
               dim=DIM):
    """tpr.go:44-260, sequential NumPy. Enriched item = (1-tw)*item +
    tw*mean(words); BPR on user . enriched; item rows get (1-tw)-scaled
    gradients, each word row tw/len(words)-scaled; L2 lam*alpha on all
    three tables."""
    rng = np.random.default_rng(SEED + 10)
    g_ui, out_ui, in_ui = gui
    g_iw, _, _ = giw
    n = g_ui.n_vertices
    user = (rng.random((n, dim)) - 0.5) / dim
    item = (rng.random((n, dim)) - 0.5) / dim
    word = (rng.random((g_iw.n_vertices, dim)) - 0.5) / dim
    src_draw = _alias_draw_factory(out_ui, 1.0, rng)
    neg_draw = _alias_draw_factory(in_ui + out_ui, 0.75, rng)

    def words_of(i):
        j = ui2iw[i]
        if j < 0:
            return np.empty(0, dtype=np.int64)
        return g_iw.indices[g_iw.indptr[j]:g_iw.indptr[j + 1]]

    def enrich(i):
        ws = words_of(i)
        if len(ws) == 0:
            return item[i].copy(), ws
        return (1 - tw) * item[i] + tw * word[ws].mean(0), ws

    cur = alpha
    amin = alpha * 1e-4
    for k in range(samples):
        u = src_draw()
        lo, hi = g_ui.indptr[u], g_ui.indptr[u + 1]
        if hi == lo:
            continue
        w = g_ui.weights[lo:hi]
        r = rng.random() * w.sum()
        pos = int(g_ui.indices[lo + np.searchsorted(np.cumsum(w), r)])
        neg = neg_draw()
        pvec, pws = enrich(pos)
        nvec, nws = enrich(neg)
        diff = user[u] @ nvec - user[u] @ pvec
        g = cur * fast_sigmoid(diff)
        ug = g * (pvec - nvec)
        pg = g * user[u]
        user[u] += ug - lam * cur * user[u]
        item[pos] += (1 - tw) * pg - lam * cur * item[pos]
        item[neg] += -(1 - tw) * pg - lam * cur * item[neg]
        if len(pws):
            word[pws] += (tw / len(pws)) * pg - lam * cur * word[pws]
        if len(nws):
            word[nws] += -(tw / len(nws)) * pg - lam * cur * word[nws]
        if (k + 1) % 10000 == 0:
            cur = max(alpha * (1 - (k + 1) / samples), amin)
    return user, item, word


def _tpr_eval(user, item, word, g_ui, g_iw, ui2iw, test_u_vid,
              test_i_vid, tw=0.5):
    rng = np.random.default_rng(1)

    def enrich(i):
        j = ui2iw[i]
        if j < 0:
            return item[i]
        ws = g_iw.indices[g_iw.indptr[j]:g_iw.indptr[j + 1]]
        if len(ws) == 0:
            return item[i]
        return (1 - tw) * item[i] + tw * word[ws].mean(0)

    sp = np.array([user[u] @ enrich(i)
                   for u, i in zip(test_u_vid, test_i_vid)])
    rand_items = rng.integers(0, item.shape[0], len(test_u_vid))
    sn = np.array([user[u] @ enrich(i)
                   for u, i in zip(test_u_vid, rand_items)])
    return float((sp[:, None] > sn[None, :]).mean())


def run_tpr():
    from smore_tpu.models.cpr import TPR

    ui_path, iw_path = "/tmp/oracle_tpr_ui.txt", "/tmp/oracle_tpr_iw.txt"
    test_u, test_i = make_text_rec(ui_path, iw_path)
    gui = _go_pronet_arrays(ui_path)
    giw = _go_pronet_arrays(iw_path)
    g_ui, g_iw = gui[0], giw[0]
    ui2iw = np.array(
        [g_iw.name2id.get(nm, -1) for nm in g_ui.names], dtype=np.int64)
    test_u_vid = np.array([g_ui.name2id[f"u{u}"] for u in test_u])
    test_i_vid = np.array([g_ui.name2id[f"i{i}"] for i in test_i])
    samples, alpha, tw = 600_000, 0.025, 0.5
    print(f"[tpr] ui {g_ui.n_vertices} vids, iw {g_iw.n_vertices}",
          flush=True)

    t0 = time.time()
    ou, oi, ow = oracle_tpr(gui, giw, ui2iw, samples, alpha, tw=tw)
    t_oracle = time.time() - t0
    o_auc = _tpr_eval(ou, oi, ow, g_ui, g_iw, ui2iw, test_u_vid,
                      test_i_vid, tw)

    t0 = time.time()
    m = TPR.load_graphs(ui_path, iw_path, seed=0, text_weight=tw)
    m.init(dim=DIM)
    m.train(sample_times=samples / 1e6, alpha=alpha, verbose=False)
    t_ours = time.time() - t0
    mu = np.zeros((g_ui.n_vertices, DIM))
    mi = np.zeros((g_ui.n_vertices, DIM))
    mw = np.zeros((g_iw.n_vertices, DIM))
    for nm, vid in m.ui.name2id.items():
        j = g_ui.name2id.get(nm)
        if j is not None:
            mu[j] = np.asarray(m.state["user"])[vid]
            mi[j] = np.asarray(m.state["item"])[vid]
    for nm, vid in m.iw.name2id.items():
        j = g_iw.name2id.get(nm)
        if j is not None and nm.startswith("w"):
            mw[j] = np.asarray(m.state["word"])[vid]
    u_auc = _tpr_eval(mu, mi, mw, g_ui, g_iw, ui2iw, test_u_vid,
                      test_i_vid, tw)
    print(f"{'tpr':14s} ours AUC={u_auc:.4f} ({t_ours:.0f}s) | "
          f"oracle {o_auc:.4f} ({t_oracle:.0f}s)", flush=True)
    return "tpr", u_auc, o_auc, None, None


# ===================================================================== #
# head-to-heads
# ===================================================================== #
def run_kg(which):
    from smore_tpu.models.kg import ComplEx, RotatE, TransE

    path = make_kg("/tmp/oracle_kg.txt")
    kg = _kg_arrays(path)
    epochs, alpha = 30, 0.01
    print(f"[{which}] {kg.n_triples} triples, {kg.n_entities} entities, "
          f"epochs={epochs}", flush=True)

    # Dim convention: Go's rotate/complex "dim" counts TOTAL real dims
    # (complex dim = dim/2, rotate.go:50); OUR RotatE/ComplEx init(dim)
    # takes the COMPLEX dim (entities are (N, 2*dim) re|im). Matched
    # arms therefore use cdim complex dims on both sides.
    cdim = DIM // 2
    t0 = time.time()
    if which == "transe":
        oe, orl = oracle_transe(kg, epochs, alpha)
        osc = lambda h, r, t: -np.linalg.norm(  # noqa: E731
            oe[h] + orl[r] - oe[t], axis=-1)
        ours = TransE(kg, seed=0)
    elif which == "rotate":
        oe, orl = oracle_rotate(kg, epochs, alpha)
        osc = lambda h, r, t: -np.sqrt(  # noqa: E731
            (np.abs(oe[h] * orl[r] - oe[t]) ** 2).sum(-1))
        ours = RotatE(kg, seed=0)
    else:
        # matched (triple, corruption) budgets: ours draws 1 corruption
        # per triple per epoch; the Go loop draws negativeSamples=10
        oe, orl = oracle_complex(kg, max(3, epochs // 10), alpha)
        osc = lambda h, r, t: (  # noqa: E731
            oe[h] * orl[r] * np.conj(oe[t])).real.sum(-1)
        ours = ComplEx(kg, seed=0)
    t_oracle = time.time() - t0
    o_mrr, o_h3 = kg_rank_eval(osc, kg.heads, kg.relations, kg.tails,
                               kg.n_entities)

    t0 = time.time()
    ours.init(dim=DIM if which == "transe" else cdim)
    ours.train(epochs=epochs, batch=1024, alpha=alpha, verbose=False)
    t_ours = time.time() - t0
    st = {k: np.asarray(v) for k, v in ours.state.items()}

    if which == "transe":
        e, rl = st["entity"], st["relation"]
        usc = lambda h, r, t: -np.linalg.norm(  # noqa: E731
            e[h] + rl[r] - e[t], axis=-1)
    elif which == "rotate":
        e, ph = st["entity"], st["relation"]

        def usc(h, r, t):
            hr, hi = e[h][:, :cdim], e[h][:, cdim:]
            tr, ti = e[t][:, :cdim], e[t][:, cdim:]
            cr, ci = np.cos(ph[r]), np.sin(ph[r])
            dr = hr * cr - hi * ci - tr
            di = hr * ci + hi * cr - ti
            return -np.sqrt((dr * dr + di * di).sum(-1))
    else:
        e, rl = st["entity"], st["relation"]

        def usc(h, r, t):
            hr, hi = e[h][:, :cdim], e[h][:, cdim:]
            tr, ti = e[t][:, :cdim], e[t][:, cdim:]
            rr, ri = rl[r][:, :cdim], rl[r][:, cdim:]
            return ((hr * rr - hi * ri) * tr
                    + (hr * ri + hi * rr) * ti).sum(-1)

    u_mrr, u_h3 = kg_rank_eval(usc, kg.heads, kg.relations, kg.tails,
                               kg.n_entities)
    print(f"{which:14s} ours MRR={u_mrr:.4f} hits@3={u_h3:.4f} "
          f"({t_ours:.0f}s) | oracle MRR={o_mrr:.4f} hits@3={o_h3:.4f} "
          f"({t_oracle:.0f}s)", flush=True)
    return which, u_mrr, o_mrr, u_h3, o_h3


def run_sne():
    from smore_tpu.graph.signed import SignedNetwork
    from smore_tpu.models.sne import SNE

    path = make_signed("/tmp/oracle_signed.txt")
    net = SignedNetwork.load_edge_list(path, undirected=False)
    epochs, spe, alpha, beta, negs = 8, 1, 0.025, 1.0, 5
    print(f"[sne] {net.n_vertices} vertices, {len(net.pos_src)}+ / "
          f"{len(net.neg_src)}- edges, epochs={epochs}", flush=True)

    t0 = time.time()
    o_src, o_tgt = oracle_sne(net, epochs, spe, alpha, beta, negs)
    t_oracle = time.time() - t0
    o_auc = auc((o_src[net.pos_src] * o_tgt[net.pos_dst]).sum(1),
                (o_src[net.neg_src] * o_tgt[net.neg_dst]).sum(1))

    t0 = time.time()
    m = SNE(net, seed=0, beta=beta, negative_samples=negs)
    m.init(dim=DIM)
    m.train(epochs=epochs, samples_per_edge=spe, alpha=alpha,
            verbose=False)
    t_ours = time.time() - t0
    s, t = np.asarray(m.state["source"]), np.asarray(m.state["target"])
    u_auc = auc((s[net.pos_src] * t[net.pos_dst]).sum(1),
                (s[net.neg_src] * t[net.neg_dst]).sum(1))
    print(f"{'sne':14s} ours sign-AUC={u_auc:.4f} ({t_ours:.0f}s) | "
          f"oracle {o_auc:.4f} ({t_oracle:.0f}s)", flush=True)
    return "sne", u_auc, o_auc, None, None


def run_ctdne():
    from smore_tpu.graph.temporal import TemporalGraph
    from smore_tpu.models.ctdne import CTDNE

    path = make_temporal("/tmp/oracle_temporal.txt")
    tg = TemporalGraph.load_edge_list(path)
    wt, ws, win, negs, alpha, tw = 16, 20, 5, 5, 0.025, 20.0
    labels_by_vid = np.array(
        [int(nm[1:]) // 150 for nm in tg.names])
    print(f"[ctdne] {tg.n_vertices} nodes, {tg.n_edges} temporal edges",
          flush=True)

    t0 = time.time()
    o_emb = oracle_ctdne(tg, wt, ws, win, negs, alpha, tw)
    t_oracle = time.time() - t0
    o_auc = community_auc_emb(o_emb, labels_by_vid)

    t0 = time.time()
    m = CTDNE(tg, seed=0, time_window=tw)
    m.init(dim=DIM)
    m.train(walk_times=wt, walk_steps=ws, window_size=win,
            negative_samples=negs, alpha=alpha, verbose=False)
    t_ours = time.time() - t0
    u_auc = community_auc_emb(np.asarray(m.state["vertex"]),
                              labels_by_vid)
    print(f"{'ctdne':14s} ours comm-AUC={u_auc:.4f} ({t_ours:.0f}s) | "
          f"oracle {o_auc:.4f} ({t_oracle:.0f}s)", flush=True)
    return "ctdne", u_auc, o_auc, None, None


def run_mp2v():
    from smore_tpu.graph.hetero import HeteroGraph
    from smore_tpu.models.metapath2vec import Metapath2Vec

    path = make_hetero("/tmp/oracle_hetero.txt")
    hg = HeteroGraph.load_edge_list(path, undirected=True)
    mp = ["author", "paper", "author"]
    # Go metapath cycling (hetero_graph.go:236-248) dead-ends an A-P-A
    # walk at length 3 (the cycled next type after the 2nd author is
    # 'author' again), so each walk yields only ~6 skip-gram pairs --
    # walk_times carries the whole budget.
    wt, ws, win, negs, alpha = 200, 16, 5, 5, 0.025
    # author a{i} topic = i // 80; papers/venues by their own prefix
    labels = np.zeros(hg.n_vertices, dtype=np.int64)
    author_rows = []
    for vid, nm in enumerate(hg.names):
        if nm.startswith("a"):
            labels[vid] = int(nm[1:]) // 80
            author_rows.append(vid)
    author_rows = np.asarray(author_rows)
    print(f"[metapath2vec] {hg.n_vertices} nodes", flush=True)

    t0 = time.time()
    o_emb = oracle_metapath2vec(hg, mp, wt, ws, win, negs, alpha)
    t_oracle = time.time() - t0
    o_auc = community_auc_emb(o_emb[author_rows], labels[author_rows])

    t0 = time.time()
    m = Metapath2Vec(hg, seed=0)
    m.add_meta_path(mp)
    m.init(dim=DIM)
    m.train(walk_times=wt, walk_steps=ws, window_size=win,
            negative_samples=negs, alpha=alpha, verbose=False)
    t_ours = time.time() - t0
    u_auc = community_auc_emb(
        np.asarray(m.state["vertex"])[author_rows], labels[author_rows])
    print(f"{'metapath2vec':14s} ours comm-AUC={u_auc:.4f} "
          f"({t_ours:.0f}s) | oracle {o_auc:.4f} ({t_oracle:.0f}s)",
          flush=True)
    return "metapath2vec", u_auc, o_auc, None, None


def make_community(path, comms=4, per=200, intra_deg=12, inter_deg=2,
                   seed=11):
    """Plain undirected community graph for the walk families: each
    vertex draws ``intra_deg`` endpoints inside its community and
    ``inter_deg`` outside -- q-sensitive structure (BFS-like q>1 stays
    local)."""
    if os.path.exists(path):
        return path
    rng = np.random.default_rng(seed)
    n = comms * per
    comm = np.arange(n) // per
    lines = []
    for v in range(n):
        c = comm[v]
        ins = rng.integers(0, per, intra_deg) + c * per
        outs = rng.integers(0, n, inter_deg)
        for u in np.concatenate([ins, outs]):
            if int(u) != v:
                lines.append(f"v{v} v{int(u)} 1\n")
    with open(path, "w") as f:
        f.writelines(lines)
    return path


def oracle_node2vec(g, p, q, walk_times, walk_steps, window, negs,
                    alpha):
    """node2vec.go:82-175 + Train :178-258, sequential NumPy.

    First step: weight-proportional TargetSample (pronet.go); later
    steps: per-neighbor bias scan (1/p return, 1.0 if the candidate is
    also a neighbor of prev, 1/q otherwise -- node2vec.go:114-165),
    cumulative-sum draw. Pairs via SkipGrams WITHOUT window shrink
    (pronet.go:310-333), updates via UpdatePair (optimizer.go:8-58),
    negatives ~ (in+out degree)^0.75 (the pronet negative table)."""
    rng = np.random.default_rng(SEED + 11)
    n = g.n_vertices
    wv = (rng.random((n, DIM)) - 0.5) / DIM
    wc = np.zeros((n, DIM))
    deg_mass = np.zeros(n)
    np.add.at(deg_mass, np.repeat(np.arange(n), np.diff(g.indptr)),
              g.weights)
    np.add.at(deg_mass, g.indices, g.weights)
    neg_draw = _alias_draw_factory(np.maximum(deg_mass, 1e-12), 0.75,
                                   rng)
    nbrs_of = [g.indices[g.indptr[v]:g.indptr[v + 1]] for v in range(n)]
    w_of = [g.weights[g.indptr[v]:g.indptr[v + 1]] for v in range(n)]
    total = walk_times * n
    count = 0
    cur = alpha
    for _ in range(walk_times):
        for v in rng.permutation(n):
            count += 1
            walk = [int(v)]
            nb = nbrs_of[v]
            if len(nb):
                w = w_of[v]
                cw = np.cumsum(w)
                first = int(nb[min(np.searchsorted(
                    cw, rng.random() * cw[-1]), len(nb) - 1)])
                walk.append(first)
                for _ in range(1, walk_steps):
                    curv, prev = walk[-1], walk[-2]
                    nb2 = nbrs_of[curv]
                    if len(nb2) == 0:
                        break
                    bias = np.where(
                        nb2 == prev, 1.0 / p,
                        np.where(np.isin(nb2, nbrs_of[prev]), 1.0,
                                 1.0 / q))
                    bw = w_of[curv] * bias
                    tot = bw.sum()
                    if tot == 0:
                        nxt = int(nb2[rng.integers(0, len(nb2))])
                    else:
                        cbw = np.cumsum(bw)
                        nxt = int(nb2[min(np.searchsorted(
                            cbw, rng.random() * cbw[-1]), len(nb2) - 1)])
                    walk.append(nxt)
            for a, b in _skipgrams(walk, window):
                _update_pair(wv, wc, a, b, neg_draw, negs, cur)
            if count % 1000 == 0:
                cur = max(alpha * (1 - count / total), alpha * 1e-4)
    return wv


def run_node2vec():
    from smore_tpu.graph.graph import Graph
    from smore_tpu.models.node2vec import Node2Vec

    path = make_community("/tmp/oracle_community.txt")
    g = Graph.load_edge_list(path, undirected=True)
    # q=2 (BFS-like) exercises the second-order bias path on both arms.
    # walk_times=3 keeps both arms mid-range (measured 2026-08-21:
    # ours 0.9989 vs oracle 0.9980); at the wt=10 default BOTH arms
    # saturate to 1.0000, and at wt=2 the known truncated-budget
    # batched-staleness gap appears (ours 0.8230 vs 0.9693 -- same
    # family as the deepwalk trunc effect, walk_base.freshness_policy).
    p, q = 0.5, 2.0
    wt, ws, win, negs, alpha = 3, 20, 5, 5, 0.025
    labels = np.array([int(nm[1:]) // 200 for nm in g.names])
    print(f"[node2vec] {g.n_vertices} nodes, {g.n_edges} edges",
          flush=True)

    t0 = time.time()
    o_emb = oracle_node2vec(g, p, q, wt, ws, win, negs, alpha)
    t_oracle = time.time() - t0
    o_auc = community_auc_emb(o_emb, labels)

    t0 = time.time()
    m = Node2Vec(g, seed=0, p=p, q=q)
    m.init(dim=DIM)
    m.train(walk_times=wt, walk_steps=ws, window_size=win,
            negative_samples=negs, p=p, q=q, alpha=alpha, verbose=False)
    t_ours = time.time() - t0
    u_auc = community_auc_emb(np.asarray(m.state["vertex"]), labels)
    print(f"{'node2vec':14s} ours comm-AUC={u_auc:.4f} ({t_ours:.0f}s) "
          f"| oracle {o_auc:.4f} ({t_oracle:.0f}s)", flush=True)
    return "node2vec", u_auc, o_auc, None, None


def oracle_fastrp(g, dim, iterations, ns, seed=42):
    """fastrp.go:66-263, sequential NumPy. Deterministic pipeline:
    very-sparse init (per (vid, d) draw: +1 w.p. 2.5%, -1 w.p. 2.5%,
    fastrp.go:129-151, vid-major order), ``iterations`` rounds of
    weighted neighbor aggregation with deg^-ns scaling and total-weight
    averaging (:154-223), block concatenation (:77-117), final L2
    normalization (:225-263). Go's rand.Float64 sequence is not
    reproducible cross-language; the oracle draws the same law from
    numpy in the same visit order, so the comparison is over the
    algorithmic pipeline, not the RNG bitstream."""
    n = g.n_vertices
    L = iterations
    d_iter = max(1, dim // (L + 1))
    rng = np.random.default_rng(seed)
    x = np.zeros((n, d_iter))
    for vid in range(n):  # vid-major, d-minor like the Go loop
        r = rng.random(d_iter)
        x[vid] = np.where(r < 0.025, 1.0, np.where(r < 0.05, -1.0, 0.0))

    indptr = np.asarray(g.indptr)
    indices = np.asarray(g.indices)
    weights = np.asarray(g.weights, dtype=np.float64)
    blocks = [x]
    cur = x
    for _ in range(L):
        nxt = np.zeros_like(cur)
        for vid in range(n):
            lo, hi = indptr[vid], indptr[vid + 1]
            if hi == lo:
                continue
            nb, w = indices[lo:hi], weights[lo:hi]
            norm = (hi - lo) ** (-ns) if ns > 0 else 1.0
            tot = w.sum()
            if tot > 0:
                nxt[vid] = (cur[nb] * w[:, None] * norm).sum(0) / tot
        blocks.append(nxt)
        cur = nxt
    emb = np.concatenate(blocks, axis=1)
    if emb.shape[1] < dim:
        emb = np.pad(emb, ((0, 0), (0, dim - emb.shape[1])))
    nrm = np.linalg.norm(emb, axis=1, keepdims=True)
    return emb / np.maximum(nrm, 1e-10)


def run_fastrp():
    from smore_tpu.graph.graph import Graph
    from smore_tpu.models.fastrp import FastRP

    path = make_community("/tmp/oracle_community.txt")
    g = Graph.load_edge_list(path, undirected=True)
    labels = np.array([int(nm[1:]) // 200 for nm in g.names])
    print(f"[fastrp] {g.n_vertices} nodes, {g.n_edges} edges", flush=True)

    # FastRP quality rides its sparse random INIT realization, so a
    # single seed is mostly RNG noise (measured spread ~0.03 sd both
    # arms); compare 5-seed means (2026-08-21: ours 0.6267 +- 0.0297
    # vs oracle 0.6105 +- 0.0328 -- overlapping, ours above).
    ou, oo = [], []
    t0 = time.time()
    for s in (42, 1, 2, 3, 4):
        oo.append(community_auc_emb(
            oracle_fastrp(g, DIM, iterations=3, ns=0.0, seed=s), labels))
        m = FastRP(g, seed=s, iterations=3)
        m.generate(dim=DIM)
        ou.append(community_auc_emb(
            np.asarray(m.state["vertex"]), labels))
    u_auc, o_auc = float(np.mean(ou)), float(np.mean(oo))
    print(f"{'fastrp':14s} ours comm-AUC={u_auc:.4f}+-"
          f"{np.std(ou, ddof=1):.4f} | oracle {o_auc:.4f}+-"
          f"{np.std(oo, ddof=1):.4f} (5 seeds, {time.time()-t0:.0f}s)",
          flush=True)
    return "fastrp", u_auc, o_auc, None, None


def run_sasrec_family(key):
    """Faithful arms for the SASRec family (VERDICT r4 item 8). The Go
    toolchain is absent, so the reference semantics (sasrec.go:553-593,
    gsasrec.go:256-275, recdenoiser.go:174-247: the transformer is
    initialized but ONLY the item-embedding table ever receives
    gradients) are reproduced exactly in-harness via
    train(forward_only=True) -- same sequences, same loss, same init,
    same schedule; the only difference is which parameters train
    (experiments/sasrec_eval.py). Rows report held-out recall@10."""
    import sasrec_eval as se

    se.make_data(se.DATA)
    names = {"sasrec": "SASRec", "gsasrec": "GSASRec",
             "recdenoiser": "RecDenoiser"}
    t0 = time.time()
    full = se.run_arm(names[key], forward_only=False)
    fwd = se.run_arm(names[key], forward_only=True)
    print(f"{key:14s} ours recall@10={full['recall@10']:.4f} | "
          f"faithful fwd-only {fwd['recall@10']:.4f} "
          f"({time.time()-t0:.0f}s)", flush=True)
    return key, full["recall@10"], fwd["recall@10"], None, None


def main():
    want = sys.argv[1:] or ["transe", "rotate", "complex", "sne", "ctdne",
                            "metapath2vec", "jodie", "han", "cpr", "tpr",
                            "node2vec", "fastrp", "sasrec", "gsasrec",
                            "recdenoiser"]
    rows = []
    for w in want:
        if w in ("transe", "rotate", "complex"):
            rows.append(run_kg(w))
        elif w == "sne":
            rows.append(run_sne())
        elif w == "ctdne":
            rows.append(run_ctdne())
        elif w == "metapath2vec":
            rows.append(run_mp2v())
        elif w == "jodie":
            rows.append(run_jodie())
        elif w == "han":
            rows.append(run_han())
        elif w == "cpr":
            rows.append(run_cpr())
        elif w == "tpr":
            rows.append(run_tpr())
        elif w == "node2vec":
            rows.append(run_node2vec())
        elif w == "fastrp":
            rows.append(run_fastrp())
        elif w in ("sasrec", "gsasrec", "recdenoiser"):
            rows.append(run_sasrec_family(w))
    print("\n| model | ours | oracle (Go semantics) | metric |")
    print("|---|---|---|---|")
    for name, u, o, uh, oh in rows:
        if name == "jodie":
            metric, extra = "pairwise acc", f" (ours+bce {uh:.3f})"
        elif name in ("sasrec", "gsasrec", "recdenoiser"):
            metric, extra = "recall@10 (faithful fwd-only arm)", ""
        elif uh is not None and oh is not None:
            metric = "MRR"
            extra = f" (hits@3 {uh:.3f} vs {oh:.3f})"
        else:
            metric, extra = "AUC", ""
        print(f"| {name} | {u:.4f} | {o:.4f} | {metric}{extra} |")


if __name__ == "__main__":
    main()
