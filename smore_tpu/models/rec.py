"""Recommendation models on a single shared embedding table:
MF, BPR, WARP, Skew-OPT.

Reference: /root/reference/src/model/{MF,BPR,WARP,SkewOPT}.cpp -- all share
the loop ``SourceSample -> TargetSample -> Update*Pair`` on ONE table
(w_vertex passed as both vertex and context), with
negative_method="no_degrees" (uniform over vertices with in-edges) set in
each constructor (MF.cpp:4-7 etc.). CLI defaults from cli/{mf,bpr,warp,
skewopt}.cpp: dim=64, sample_times=10, neg=5, alpha=0.025, reg=0.01;
skewopt adds xi=10, omega=3, eta=3.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from smore_tpu.models.base import (
    clamp_batch,
    hoisted_scan_step,
    PairModelBase,
    TrainDriver,
    init_embedding,
)
from smore_tpu.ops.update import (
    bpr_shared_negs_step,
    bpr_step,
    mf_shared_negs_step,
    mf_step,
    skewbpr_shared_negs_step,
    skewbpr_step,
    warp_shared_pool_step,
    warp_step,
)


class _SharedTableRec(PairModelBase):
    """Shared scaffolding: one table, src/pos/negs draws, one kernel."""

    negative_method = "no_degrees"
    default_shared_negatives = 256

    def init(self, dim: int) -> None:
        self.dim = dim
        k1, _ = jax.random.split(self._key())
        self.state = {"vertex": init_embedding(k1, self.graph.n_vertices, dim)}
        self.build_sampler()

    def _kernel(self, state, tables, src, pos, negs, key, alpha):
        raise NotImplementedError

    def _shared_kernel(self, state, src, pos, pool, extra, alpha,
                       collision):
        """Shared-pool fast path (Ks negatives per step as one matmul);
        ``extra`` carries WARP's per-sample trial indices."""
        raise NotImplementedError

    def _n_negs(self) -> int:
        raise NotImplementedError

    def _needs_trials(self) -> bool:
        return False  # WARP overrides

    def _make_step(self, batch: int, collision: str, hoist: int = 1,
                   shared_negatives: int = 0):
        R = self._n_negs()
        Ks = shared_negatives

        def draw(tables, key, m):
            """Draws for ``m`` consecutive batches in one shot."""
            k1, k2, k3, k4 = jax.random.split(key, 4)
            n = m * batch
            if tables.has_edge_table:
                # one-gather joint (user, item) draw, same two-stage law
                src, pos = tables.edge_sample(k1, (n,))
            else:
                src = tables.source_sample(k1, (n,))
                pos = tables.target_sample(k2, src)
            src = src.reshape(m, batch)
            pos = pos.reshape(m, batch)
            if Ks:
                negs = tables.negative_sample(k3, (m, Ks))
                if self._needs_trials():
                    # WARP: tie-break + gate uniforms (see
                    # warp_shared_pool_step's marginalized trial law)
                    extra = jax.random.uniform(k4, (m, batch, Ks + 1))
                else:
                    extra = jnp.zeros((m, 1), jnp.int32)
            else:
                negs = tables.negative_sample(k3, (m, batch, R))
                extra = jnp.zeros((m, 1), jnp.int32)
            return src, pos, negs, extra

        def update(st, x, a):
            src, pos, negs, extra = x
            if Ks:
                w, loss = self._shared_kernel(
                    st, src, pos, negs, extra, a, collision
                )
            else:
                w, loss = self._kernel(st, src, pos, negs, a, collision)
            return {"vertex": w}, loss

        if hoist > 1:
            # mega-draw for ``hoist`` batches then an inner scan --
            # identical law (iid draws, state-independent; the same
            # transform as LINE's hoist, models/line.py)
            return hoisted_scan_step(
                lambda tables, key: draw(tables, key, hoist),
                update, hoist,
            )

        def step(state, tables, key, alpha):
            x = draw(tables, key, 1)
            return update(state, tuple(a[0] for a in x), alpha)

        return step

    def train(
        self,
        sample_times: int = 10,
        alpha: float = 0.025,
        batch: int = 8192,
        steps_per_call: int = 128,
        collision: str = "sum",
        hoist: int = 0,  # draws for N batches as one mega-draw before an
        # inner scan (identical law; see models/line.py). 0 = auto: 8 on
        # the shared-pool single-stream path, else 1.
        shared_negatives: int = -1,  # Ks-row shared negative pool per
        # step, scored against every sample as one matmul with k_equiv/Ks
        # scaling (ops/update.py shared-pool rec kernels) -- the same
        # expectation-preserving transform as LINE's shared negatives.
        # 0 = the reference's per-sample fresh negatives; -1 = class
        # default (256 for MF/BPR/WARP, whose shared-pool parity holds;
        # 0 for SkewOPT -- its expectation-form rounds cost recall@10
        # 0.911 vs 0.923, PERF_NOTES round 3).
        mesh=None,
        verbose: bool = True,
        **kw,
    ) -> None:
        for k, v in kw.items():
            if not hasattr(self, k):
                raise TypeError(f"unknown train arg {k!r}")
            setattr(self, k, v)
        batch = clamp_batch(self.graph.n_vertices, batch)
        if shared_negatives < 0:
            shared_negatives = self.default_shared_negatives
        if shared_negatives:
            shared_negatives = min(shared_negatives, batch)
        if mesh is not None:
            hoist = 1  # DP merges per-device deltas every step
        elif hoist == 0:
            hoist = 8 if shared_negatives else 1
        driver = TrainDriver(
            self._make_step(batch, collision, hoist, shared_negatives),
            ctx=self.build_sampler(),
            samples_per_step=batch * hoist,
            alpha=alpha,
            total_samples=int(sample_times * 1_000_000),
            steps_per_call=max(1, steps_per_call // hoist),
            micro_steps=hoist,
            mesh=mesh,
            **self._ckpt_kw(),
        )
        self.state = driver.train(self.state, self._key(), verbose=verbose)


class MF(_SharedTableRec):
    """Matrix factorization via UpdateFactorizedPair (proNet.cpp:2591)."""

    def __init__(self, graph, seed: int = 0, reg: float = 0.01,
                 negative_samples: int = 5):
        super().__init__(graph, seed)
        self.reg = reg
        self.negative_samples = negative_samples

    def _n_negs(self):
        return self.negative_samples

    def _kernel(self, state, src, pos, negs, alpha, collision):
        w, _, loss = mf_step(
            state["vertex"], state["vertex"], src, pos, negs, alpha,
            reg=self.reg, shared_table=True, collision=collision,
        )
        return w, loss

    def _shared_kernel(self, state, src, pos, pool, extra, alpha,
                       collision):
        w, _, loss = mf_shared_negs_step(
            state["vertex"], state["vertex"], src, pos, pool, alpha,
            k_equiv=self.negative_samples, reg=self.reg,
            shared_table=True, collision=collision,
        )
        return w, loss


class BPR(_SharedTableRec):
    """Bayesian personalized ranking via UpdateBPRPair
    (proNet.cpp:1406-1456; 5 fresh negatives per drawn pair)."""

    def __init__(self, graph, seed: int = 0, rounds: int = 5):
        super().__init__(graph, seed)
        self.rounds = rounds

    def _n_negs(self):
        return self.rounds

    def _kernel(self, state, src, pos, negs, alpha, collision):
        w, _, loss = bpr_step(
            state["vertex"], state["vertex"], src, pos, negs, alpha,
            shared_table=True, collision=collision,
        )
        return w, loss

    def _shared_kernel(self, state, src, pos, pool, extra, alpha,
                       collision):
        w, _, loss = bpr_shared_negs_step(
            state["vertex"], state["vertex"], src, pos, pool, alpha,
            k_equiv=self.rounds, shared_table=True, collision=collision,
        )
        return w, loss


class WARP(_SharedTableRec):
    """WSABIE k-order ranking via UpdateWARPPair (proNet.cpp:1353-1404;
    first margin violator among up to 32 trials gets the update)."""

    def __init__(self, graph, seed: int = 0, trials: int = 32):
        super().__init__(graph, seed)
        self.trials = trials

    def _n_negs(self):
        return self.trials

    def _kernel(self, state, src, pos, negs, alpha, collision):
        w, _, loss = warp_step(
            state["vertex"], state["vertex"], src, pos, negs, alpha,
            shared_table=True, collision=collision,
        )
        return w, loss

    def _needs_trials(self):
        return True

    def _shared_kernel(self, state, src, pos, pool, extra, alpha,
                       collision):
        w, _, loss = warp_shared_pool_step(
            state["vertex"], state["vertex"], src, pos, pool, extra,
            alpha, trials=self.trials, shared_table=True,
            collision=collision,
        )
        return w, loss


class SkewOPT(_SharedTableRec):
    """Skew-OPT (UAI'20) via UpdateSBPRPair (proNet.cpp:1517-1566;
    16 negatives, (xi, omega, eta) skewed logistic)."""

    # Round-3 demoted the shared pool on a recall deficit (0.9106 vs
    # 0.9231) that round 4 root-caused to UNDIRECTED loading (the
    # reference CLIs hardcode directed, cli/skewopt.cpp:69). Re-tested
    # DIRECTED at 3 seeds/side (experiments/rec_repromote.py, round 5):
    # r@10 0.9223 +- 0.0007 vs ref 0.9226 +- 0.0001, faster than
    # per-sample negatives -- the pool is back as the default.
    default_shared_negatives = 256

    def __init__(self, graph, seed: int = 0, xi: float = 10.0,
                 omega: float = 3.0, eta: int = 3, rounds: int = 16):
        super().__init__(graph, seed)
        self.xi = xi
        self.omega = omega
        self.eta = eta
        self.rounds = rounds

    def _n_negs(self):
        return self.rounds

    def _kernel(self, state, src, pos, negs, alpha, collision):
        w, _, loss = skewbpr_step(
            state["vertex"], state["vertex"], src, pos, negs, alpha,
            xi=self.xi, omega=self.omega, eta=self.eta,
            shared_table=True, collision=collision,
        )
        return w, loss

    def _shared_kernel(self, state, src, pos, pool, extra, alpha,
                       collision):
        w, _, loss = skewbpr_shared_negs_step(
            state["vertex"], state["vertex"], src, pos, pool, alpha,
            k_equiv=self.rounds, xi=self.xi, omega=self.omega,
            eta=self.eta, shared_table=True, collision=collision,
        )
        return w, loss
