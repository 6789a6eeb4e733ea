"""Shared model scaffolding: embedding tables + the jitted training driver.

The reference's canonical model protocol is
``LoadEdgeList -> Init -> Train -> SaveWeights`` (every src/model/*.cpp and
cmd/*/main.go). Here:

  - ``Init`` builds device-resident embedding tables
    (vertex ~ U(-0.5, 0.5)/dim, context = 0, matching e.g.
    /root/reference/src/model/LINE.cpp Init) and the SamplerTables.
  - ``Train`` replaces the reference's per-thread hogwild while-loop
    (LINE.cpp:162-193) with: one jitted function that runs
    ``steps_per_call`` scan iterations, each drawing a fixed-shape batch
    on-device and applying a fused update; the Python loop just re-invokes
    it with donated buffers until the sample budget is spent.
  - Linear alpha decay to alpha_min = alpha * 1e-4 is computed per-step
    from the global sample counter (LINE.cpp:176-187 semantics).
"""

from __future__ import annotations

import time
from functools import partial
from typing import Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from smore_tpu.graph.graph import Graph
from smore_tpu.io.embeddings import save_embeddings, warm_start
from smore_tpu.sampling.tables import SamplerTables

# state is a dict name -> (rows, dim) table
State = Dict[str, jnp.ndarray]
# step_fn(state, ctx, key, alpha) -> (state, loss); must be jit/scan-safe.
# ``ctx`` is an arbitrary pytree of device arrays the step reads but does
# not update (sampler tables, walk buffers). It MUST be passed as an
# argument -- closing over device arrays bakes them into the executable as
# constants, which explodes compile time and duplicates HBM.
StepFn = Callable[
    [State, object, jax.Array, jnp.ndarray], Tuple[State, jnp.ndarray]
]

ALPHA_MIN_FRAC = 1e-4  # reference: alpha_min = alpha * 0.0001


def hoisted_scan_step(draw_fn, update_fn, hoist: int):
    """Build the hoisted StepFn shared by every mega-draw model path.

    draw_fn(ctx, key) -> tuple of arrays with a leading (hoist,) axis
    (the mega-draw: ``hoist`` batches' worth of samples in one shot;
    must be state-independent so the hoist preserves the sampling law).
    update_fn(state, x, alpha) -> (state, loss) applies ONE inner batch.
    The returned step consumes the (hoist,)-vector alpha that
    TrainDriver(micro_steps=hoist) supplies (per-inner-batch decay)."""

    def step(state, ctx, key, alphas):
        xs = draw_fn(ctx, key)
        n = len(xs)
        state, losses = jax.lax.scan(
            lambda st, x: update_fn(st, x[:n], x[n]),
            state, tuple(xs) + (alphas,),
        )
        return state, jnp.mean(losses)

    return step


def freshness_policy(
    total_units: int,
    batch: int,
    hoist: int,
    min_updates: int = 1536,
    min_batch: int = 8,
) -> tuple:
    """Truncated-budget freshness floor (stale-snapshot mitigation).

    A batched step applies ``batch`` samples against ONE table snapshot;
    the reference applies them one at a time, each seeing all previous
    writes (e.g. DeepWalk.cpp:133-148). At full default budgets the
    sequential-snapshot count total/batch is in the thousands and
    quality parity holds, but at truncated budgets (e.g. deepwalk
    -walk_times 2) the run degenerates to a few hundred snapshots and
    convergence lags the reference (measured: link-AUC 0.66 vs 0.94 at
    1/5 budget, experiments/walk_parity.py). When the run would see
    fewer than ``min_updates`` sequential updates, shrink the per-update
    batch and raise the micro-step factor to compensate, so the per-call
    draw volume (batch * hoist) stays roughly constant and throughput
    survives while per-sample freshness approaches the reference's.

    ``min_updates`` = 1536 sits just below the walk family's DEFAULT
    budget snapshot count (walk_times=10 on the 20k parity graph = 1562
    steps at batch 128, where parity holds at 0.9966 vs 0.9958), so
    default-budget configs are untouched and only genuinely truncated
    runs re-batch.

    Returns the adjusted (batch, hoist).
    """
    if batch <= min_batch or total_units >= min_updates * batch:
        return batch, hoist
    new_batch = int(max(min_batch, total_units // min_updates))
    grow = max(1, batch // new_batch)
    return new_batch, min(max(1, hoist) * grow, 64)


def trunc_mass_multiplier(rebatched: int, tiny: int = 64) -> float:
    """Step-mass multiplier for the inner-pass bootstrap at truncated
    budgets (WalkSGNSBase._run).

    Truncated budgets sit at the convergence KNEE, where the reference's
    sequential per-sample updates (e.g. DeepWalk.cpp:133-148 applying
    each pair against the freshest table) compound faster per unit step
    mass than batched ones. Measured (round 5, node2vec walk_times=2 vs
    its sequential oracle): x2 reads 0.823 vs oracle 0.969; x3 closes it
    (0.997) and lifts deepwalk/walklets truncated parity to 0.975/0.976
    vs ref 0.941/0.940. BATCH-AWARE: x3 is calibrated where the
    rebatched step is tiny (8-26 rows); at larger rebatched steps (APP's
    2M-walk budget rebatches to ~1300 rows) the same mass per stale
    snapshot COLLAPSES the tables (all-vertex/all-context
    anti-alignment, measured round 5) -- those keep the round-3 x2.
    """
    return 3.0 if rebatched <= tiny else 2.0


def clamp_batch(n_rows: int, batch: int, group: int = 1) -> int:
    """Stability guard for collision="sum" batched updates.

    A batched step applies each row's SUMMED in-batch gradient against one
    stale table snapshot; when batch greatly exceeds the table's row count
    every row absorbs ~batch/n_rows gradients at once and the update
    overshoots (the reference applies them sequentially, so it cannot).
    The 32768 default batch NaNs on the README 6-vertex toy net
    (README.md:49-66) without this. Empirical bound on the 50k-vertex
    bench graph: batch=32768 passes the 40M-sample AUC gate, 65536 fails
    (PERF_NOTES.md) -- so cap batch at n_rows, keeping it a multiple of
    the source draw group.
    """
    b = max(min(batch, n_rows), group)
    return max(b - b % group, group)


def init_embedding(
    key: jax.Array, rows: int, dim: int, scale: Optional[float] = None
) -> jnp.ndarray:
    """Reference init: uniform(-0.5, 0.5)/dim (e.g. LINE.cpp Init)."""
    if scale is None:
        scale = 1.0 / dim
    return (jax.random.uniform(key, (rows, dim), dtype=jnp.float32) - 0.5) * scale


def zeros_embedding(rows: int, dim: int) -> jnp.ndarray:
    return jnp.zeros((rows, dim), dtype=jnp.float32)


class TrainDriver:
    """Runs a StepFn for a total number of samples with linear alpha decay.

    samples_per_step: how many logical edge samples one step consumes
    (= batch size for pair models; batch * pairs for walk models), used
    for the alpha schedule and throughput reporting.
    """

    def __init__(
        self,
        step_fn: StepFn,
        ctx,
        samples_per_step: int,
        alpha: float,
        total_samples: int,
        steps_per_call: int = 256,
        monitor: bool = True,
        mesh=None,
        sharding: str = "dp",
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 1,
        resume: bool = True,
        micro_steps: int = 1,
    ):
        """mesh: optional jax.sharding.Mesh with axis "d". When given,
        the call runs data-parallel via shard_map: each device draws an
        INDEPENDENT sample stream from its own PRNG key (the multi-chip
        analog of the reference's per-thread RNG,
        /root/reference/src/random.cpp:5-13) against replicated tables;
        per-device state deltas are psum-merged each step (sum over
        devices == collision="sum" over the combined batch). Effective
        samples per step = samples_per_step * n_devices.

        sharding: "dp" (default, the shard_map mode above) or "rows" —
        the large-table mode (SURVEY.md 5.8): embedding tables are
        row-sharded over the mesh (``P("d", None)``) and the SAME logical
        single-stream program is GSPMD-partitioned, XLA inserting the
        all-gather / all-to-all collectives for the random-row gathers
        and scatter-adds. Unlike "dp" (whose per-step psum moves
        the full (N, D) delta), "rows" keeps per-step traffic O(batch*D),
        so it scales to tables that don't fit one card's memory. Semantics
        are bit-identical to single-chip (one logical sample stream), so
        quality needs no re-gating.

        checkpoint_path: when set, the FULL training state (tables + PRNG
        key + step counter) is checkpointed every
        ``checkpoint_every`` jit calls and once at the end; if
        ``resume`` and the path already holds a checkpoint, training
        continues from it — the alpha schedule is a pure function of the
        restored step counter, so kill-and-resume is step-identical to an
        uninterrupted run. (The reference has no mid-train persistence,
        SURVEY.md 5.4 — this is the production upgrade on top of its
        final-dump/warm-start surface.)

        micro_steps: when > 1, step_fn consumes micro_steps inner update
        batches per call (the hoisted mega-draw path, SamplerTables.
        draw_edge_batches_hoisted) and ``alpha`` is passed as a
        (micro_steps,) vector — one linearly-decayed value per inner
        batch, so the schedule matches the unhoisted law at per-batch
        granularity. samples_per_step must already count ALL inner
        batches (batch * micro_steps)."""
        if sharding not in ("dp", "rows", "hogwild"):
            raise ValueError(
                f"sharding must be 'dp', 'rows' or 'hogwild', got {sharding!r}"
            )
        if micro_steps > 1 and mesh is not None and sharding == "dp":
            # DP merges per-device deltas EVERY step; hoisting inner
            # batches would change the merge cadence (callers force
            # hoist=1 under DP -- this guards direct TrainDriver use)
            raise ValueError("micro_steps > 1 is incompatible with DP "
                             "sharding (use sharding='rows' or no mesh)")
        self.step_fn = step_fn
        self.ctx = ctx
        self.mesh = mesh
        self.sharding = sharding
        # "rows" runs ONE logical stream (GSPMD splits the work, not the
        # sample law), so the schedule is unchanged; "dp" multiplies the
        # per-step sample count by the device count.
        # "hogwild" (multi-chip banded fast path): each device runs an
        # INDEPENDENT full-law sample stream against a replicated table
        # copy for a whole jit call, then per-device deltas are
        # psum-merged -- the mesh analog of the reference's hogwild
        # threads racing on one shared table with no coordination
        # (/root/reference/src/model/LINE.cpp:162 `#pragma omp parallel
        # for`; SURVEY.md 5.8). The merge is collision="sum" at call
        # cadence: within-call staleness replaces the reference's
        # unbounded cross-thread staleness, and the merge itself is the
        # same delta-sum semantic the in-batch collision law gates.
        self.n_shards = (
            1 if (mesh is None or sharding == "rows") else mesh.devices.size
        )
        self.samples_per_step = samples_per_step * self.n_shards
        self.alpha = float(alpha)
        self.total_samples = int(total_samples)
        self.steps_per_call = int(steps_per_call)
        self.monitor = monitor
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = max(1, int(checkpoint_every))
        self.resume = resume
        self.micro_steps = max(1, int(micro_steps))
        # set again in train(); initialized here so readers of a driver
        # whose train() hasn't run (or was interrupted) see 0 / None
        # instead of AttributeError
        self.executed_samples = 0
        self.wall_s = self.first_call_s = 0.0
        self.steady_samples_per_s = None

    def _wrap_dp(self, step_fn: StepFn) -> StepFn:
        """Data-parallel step: shard_map over per-device keys."""
        from jax.sharding import PartitionSpec as P

        mesh = self.mesh

        def dp_step(state, ctx, keys, alpha):
            # keys: (n_dev,) key array, one per device
            def shard_fn(state, ctx, key, alpha):
                key = key[0]  # unwrap this shard's singleton leading dim
                new_state, loss = step_fn(state, ctx, key, alpha)
                delta = jax.tree.map(lambda n, o: n - o, new_state, state)
                delta = jax.lax.psum(delta, "d")
                state = jax.tree.map(lambda o, d: o + d, state, delta)
                return state, jax.lax.pmean(loss, "d")

            f = jax.shard_map(
                shard_fn, mesh=mesh, in_specs=(P(), P(), P("d"), P()),
                out_specs=(P(), P()), check_vma=False,
            )
            return f(state, ctx, keys, alpha)

        return dp_step

    def _make_call(self):
        step_fn = self.step_fn
        use_dp = self.mesh is not None and self.sharding == "dp"
        use_hogwild = self.mesh is not None and self.sharding == "hogwild"
        if use_dp:
            step_fn = self._wrap_dp(step_fn)
        S = self.steps_per_call
        n_shards = self.n_shards
        M = self.micro_steps

        # Schedule parameters (alpha0, alpha_min, progress scale) are traced
        # scalars, NOT baked-in constants: one compiled executable serves
        # every sample budget / learning rate for a given (shapes, S).
        def run(state: State, ctx, key: jax.Array, sched: jnp.ndarray):
            step0, alpha0, alpha_min, inv_total = sched

            def body(carry, i):
                state, key = carry
                key, sub = jax.random.split(key)
                progress = (step0 + i) * inv_total
                if M > 1:  # per-inner-batch decay (see micro_steps docs)
                    progress = progress + (
                        jnp.arange(M, dtype=jnp.float32) / M
                    ) * inv_total
                alpha = jnp.maximum(alpha0 * (1.0 - progress), alpha_min)
                if use_dp:  # one key per device, even on a 1-device mesh
                    sub = jax.random.split(sub, n_shards)
                state, loss = step_fn(state, ctx, sub, alpha.astype(jnp.float32))
                return (state, key), loss

            (state, key), losses = jax.lax.scan(
                body, (state, key), jnp.arange(S, dtype=jnp.float32)
            )
            return state, key, jnp.mean(losses)

        if not use_hogwild:
            return jax.jit(run, donate_argnums=(0,))

        # hogwild: the WHOLE call runs per-device under shard_map (each
        # device scans S steps on its own PRNG stream against its table
        # copy), deltas psum-merge once per call (see __init__ docs).
        from jax.sharding import PartitionSpec as P

        mesh = self.mesh

        def hog_run(state, ctx, keys, sched):
            def shard_fn(state, ctx, keys, sched):
                new_state, key2, loss = run(state, ctx, keys[0], sched)
                delta = jax.tree.map(lambda n, o: n - o, new_state, state)
                delta = jax.lax.psum(delta, "d")
                state = jax.tree.map(lambda o, d: o + d, state, delta)
                return state, key2[None], jax.lax.pmean(loss, "d")

            f = jax.shard_map(
                shard_fn, mesh=mesh, in_specs=(P(), P(), P("d"), P()),
                out_specs=(P(), P("d"), P()), check_vma=False,
            )
            return f(state, ctx, keys, sched)

        return jax.jit(hog_run, donate_argnums=(0,))

    def _save_ckpt(self, state: State, key: jax.Array, done: int) -> None:
        from smore_tpu.utils.checkpoint import save_checkpoint

        save_checkpoint(
            self.checkpoint_path,
            jax.device_get(state),
            step=done,
            extra={"key": np.asarray(key)},
        )

    def _maybe_resume(self, state: State, key: jax.Array):
        """Restore (state, key, done) from checkpoint_path if present."""
        from smore_tpu.utils.checkpoint import (
            checkpoint_exists,
            load_checkpoint,
        )

        if not (
            self.checkpoint_path
            and self.resume
            and checkpoint_exists(self.checkpoint_path)
        ):
            return state, key, 0
        loaded, done, extra = load_checkpoint(self.checkpoint_path)
        state = jax.tree.map(jnp.asarray, loaded)
        if extra and "key" in extra:
            key = jnp.asarray(np.asarray(extra["key"]).astype(np.uint32))
        return state, key, int(done)

    def train(self, state: State, key: jax.Array, verbose: bool = True) -> State:
        call = self._make_call()
        steps_total = max(1, -(-self.total_samples // self.samples_per_step))
        done = 0
        if self.checkpoint_path:
            state, key, done = self._maybe_resume(state, key)
        done0 = done
        if self.mesh is not None and self.sharding == "hogwild":
            # one independent PRNG stream per device (the analog of the
            # reference's per-thread RNG); a resumed checkpoint already
            # holds the (n_dev, 2) key array
            if key.ndim == 1:
                key = jax.random.split(key, self.mesh.devices.size)
        if self.mesh is not None and self.sharding == "rows":
            from smore_tpu.parallel.mesh import replicated, shard_state

            # row sharding must divide evenly: pad each table to a multiple
            # of the device count. Draws never reach the extra rows, and
            # the returned tables keep them (slicing them off would gather
            # the whole table onto every device).
            n_dev = self.mesh.devices.size
            state = jax.tree.map(
                lambda x: jnp.pad(x, ((0, -x.shape[0] % n_dev), (0, 0)))
                if getattr(x, "ndim", 0) == 2 else x,
                state,
            )
            state = shard_state(state, self.mesh)
            self.ctx = jax.tree.map(
                lambda x: jax.device_put(x, replicated(self.mesh))
                if hasattr(x, "ndim") else x,
                self.ctx,
            )
        calls = 0
        t0 = time.time()
        last_loss = float("nan")
        loss = None
        alpha0 = self.alpha
        sched_tail = (
            alpha0,
            alpha0 * ALPHA_MIN_FRAC,
            float(self.samples_per_step) / float(max(self.total_samples, 1)),
        )
        while done < steps_total:
            sched = jnp.asarray((float(done),) + sched_tail, dtype=jnp.float32)
            state, key, loss = call(state, self.ctx, key, sched)
            done += self.steps_per_call
            calls += 1
            if calls == 1:
                # the first call compiles: time it apart from the rest
                state = jax.block_until_ready(state)
                self.first_call_s = time.time() - t0
            if self.checkpoint_path and (
                calls % self.checkpoint_every == 0 or done >= steps_total
            ):
                self._save_ckpt(state, key, done)
            if verbose and self.monitor:
                last_loss = float(loss)
                pct = min(100.0, 100.0 * done / steps_total)
                el = time.time() - t0
                sps = done * self.samples_per_step / max(el, 1e-9)
                print(
                    f"\tloss: {last_loss:.5f}\tprogress: {pct:.1f}%\t"
                    f"samples/sec: {sps:,.0f}",
                    end="\r",
                    flush=True,
                )
        state = jax.block_until_ready(state)
        self.wall_s = time.time() - t0
        # Work ACTUALLY performed by THIS call (excludes checkpoint-
        # restored steps): the loop rounds total_samples up to whole jit
        # calls (done >= steps_total), so throughput reads should divide
        # executed_samples by wall, not the request.
        self.executed_samples = (done - done0) * self.samples_per_step
        # steady-state rate: every call after the first (None if only one)
        per_call = self.steps_per_call * self.samples_per_step
        self.steady_samples_per_s = (
            (self.executed_samples - per_call)
            / max(self.wall_s - self.first_call_s, 1e-9)
            if calls > 1 else None
        )
        if verbose and self.monitor:
            n = self.executed_samples
            line = (f"\n\tdone: {n:,} samples in {self.wall_s:.2f}s "
                    f"({n / max(self.wall_s, 1e-9):,.0f} samples/sec)")
            if self.steady_samples_per_s is not None:
                line += (f"; first call {self.first_call_s:.2f}s (includes "
                         f"compile), then {self.steady_samples_per_s:,.0f} "
                         f"samples/sec")
            print(line)
        return state


class PairModelBase:
    """Base for sampled-pair embedding models (LINE/HPE/MF/BPR family)."""

    vertex_method = "out_degrees"
    negative_method = "degrees"

    def __init__(self, graph: Graph, seed: int = 0):
        self.graph = graph
        self.seed = seed
        self.tables: Optional[SamplerTables] = None
        self.state: State = {}
        self.dim: int = 0

    # -- protocol ------------------------------------------------------- #
    @classmethod
    def load_edge_list(cls, path: str, undirected: bool = True, **kw):
        g = Graph.load_edge_list(path, undirected=undirected)
        return cls(g, **kw)

    def build_sampler(self) -> SamplerTables:
        if self.tables is None:
            self.tables = SamplerTables.build(
                self.graph,
                vertex_method=self.vertex_method,
                negative_method=self.negative_method,
            )
        return self.tables

    def init(self, dim: int, **kw) -> None:
        raise NotImplementedError

    def train(self, **kw) -> None:
        raise NotImplementedError

    def set_checkpoint(
        self, path: Optional[str], every: int = 1, resume: bool = True
    ) -> None:
        """Enable periodic checkpoint + resume for subsequent train() calls
        (every = jit calls between saves). Models whose training has
        multiple driver phases suffix the path per phase."""
        if path is None:
            self._ckpt = None
        else:
            self._ckpt = {
                "checkpoint_path": path,
                "checkpoint_every": every,
                "resume": resume,
            }

    def _ckpt_kw(self, phase: Optional[str] = None) -> dict:
        ck = getattr(self, "_ckpt", None)
        if not ck:
            return {}
        kw = dict(ck)
        if phase:
            import os

            kw["checkpoint_path"] = os.path.join(kw["checkpoint_path"], phase)
        return kw

    def save_weights(self, path: str, table: str = "vertex") -> None:
        save_embeddings(path, self.graph.names, np.asarray(self.state[table]))

    def load_pretrain(self, path: str, table: str = "vertex") -> None:
        self.state[table] = jnp.asarray(
            warm_start(np.asarray(self.state[table]), self.graph.names, path)
        )

    # -- helpers -------------------------------------------------------- #
    def _key(self) -> jax.Array:
        return jax.random.PRNGKey(self.seed)
