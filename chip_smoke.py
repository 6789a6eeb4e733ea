"""Smoke run of smore-tpu on one NVIDIA GPU: the quickest proof that the
system starts and trains correctly on the card.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the mesh phase only

Phases (one process; any failure stops the run with a non-zero exit):

1. environment: the card's name and power limit, JAX's devices, optional
   packages, the native loader and the compile-cache directory;
2. step: the banded SGNS update step compiled at Youtube-scale widths
   (1.1M rows, D=64, B=32768, Ks=128), compared with a float64 NumPy
   reference at the production precision and at HIGHEST, and timed beside
   the unbanded step; then the tests marked ``gpu``;
3. LINE order 2 on the seeded Youtube-shaped graph (1.1M vertices, ~3M
   links) through the CLI, 40M samples: the saved file is read back and
   checked, and its community AUC must beat 0.55;
4. the same on the 50k-vertex community graph (the unbanded path).

``--four-cards`` trains LINE at Youtube scale on a 4-device mesh in the
hogwild and the row-sharded mode and compares both with one card at the
same total budget (samples/s and community AUC, reported, not gated: the
mesh modes' quality at this budget is a measurement, not yet a contract).

The last line of standard output is one JSON object naming the device.
Without a GPU the script exits non-zero before printing it.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
YT_AUC_GATE = 0.55
SAMPLE_TIMES = 40  # millions of edge samples, the quality-gate budget
# Tolerances against the float64 reference. At HIGHEST only the order and
# rounding of float32 sums differ: 1e-5 of the largest updated row. At the
# production precision the dots may run as TF32 (10-bit mantissa, ~1e-3
# relative per product): 1e-2 of the largest update.
HIGHEST_RTOL = 1e-5
TF32_RTOL = 1e-2
# step-phase widths: Youtube scale (rows, dim, batch, negative pool)
WIDTHS = dict(n=1_100_000, d=64, b=32768, ks=128, k_equiv=5, band=None)


def log(msg: str = "") -> None:
    print(msg, flush=True)


def require_gpu():
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke.py needs a GPU; JAX found {devs}")
    return devs


# ------------------------------------------------------------ phase 1 --
def phase_env(devs) -> None:
    import jax

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"nvidia-smi: {smi}")
    log(f"jax {jax.__version__}: {devs}")
    for mod in ("flax", "orbax"):
        log(f"{mod} importable: {importlib.util.find_spec(mod) is not None}")
    from smore_tpu.native import fastgraph

    log(f"native loader built: {fastgraph.available()}")
    log(f"compile cache: {jax.config.jax_compilation_cache_dir}")


# ------------------------------------------------------------ phase 2 --
def numpy_sgns_step(wv, wc, src, pos, negs, alpha, k_equiv):
    """Float64 NumPy reference of the shared-negative SGNS update (every
    repeated row takes every update, as the reference's hogwild threads
    apply them). Returns the updated (vertex, context) tables."""
    wv, wc = wv.astype(np.float64), wc.astype(np.float64)
    v, cp, cn = wv[src], wc[pos], wc[negs]
    g_pos = (1.0 - 1.0 / (1.0 + np.exp(-(v * cp).sum(1)))) * alpha
    g_neg = -alpha * k_equiv / len(negs) / (1.0 + np.exp(-(v @ cn.T)))
    np.add.at(wv, src, g_pos[:, None] * cp + g_neg @ cn)
    np.add.at(wc, pos, g_pos[:, None] * v)
    np.add.at(wc, negs, g_neg.T @ v)
    return wv, wc


def _time_steps(fn, tables, xs, reps):
    """Seconds per micro-step of ``fn`` (one jitted scan over xs)."""
    import jax

    tables = jax.block_until_ready(fn(tables, xs))  # compile + warm up
    t0 = time.perf_counter()
    for _ in range(reps):
        tables = fn(tables, xs)
    jax.block_until_ready(tables)
    return (time.perf_counter() - t0) / (reps * xs[0].shape[0])


def phase_step() -> None:
    """The banded SGNS step compiled at Youtube widths: deviation from the
    float64 reference at the production precision and at HIGHEST, memory
    and time per micro-step, beside the plain unbanded step."""
    import jax
    import jax.numpy as jnp
    import pytest

    from smore_tpu.ops.update import (
        SGNS_PRECISION,
        sgns_shared_negs_step,
        sgns_shared_negs_step_banded,
    )
    from smore_tpu.sampling.banded import DEFAULT_BAND_SIZE

    n, d, b, ks, k_eq = (WIDTHS[k] for k in ("n", "d", "b", "ks", "k_equiv"))
    band = WIDTHS["band"] or DEFAULT_BAND_SIZE
    n_bands = -(-n // band)
    n_pad = n_bands * band
    rng = np.random.default_rng(0)
    wv0 = rng.normal(0, 0.1, (n_pad, d)).astype(np.float32)
    wc0 = rng.normal(0, 0.1, (n_pad, d)).astype(np.float32)
    # 8 micro-steps per call (the production hoist), each on its own band
    # pair, power-law rows inside the bands (hub rows repeat)
    steps = 8
    p = 1.0 / np.arange(1, band + 1) ** 0.8
    p /= p.sum()
    sbs = rng.integers(0, n_bands, steps) * band
    dbs = rng.integers(0, n_bands, steps) * band
    src = sbs[:, None] + rng.choice(band, (steps, b), p=p)
    pos = dbs[:, None] + rng.choice(band, (steps, b), p=p)
    negs = rng.integers(0, n, (steps, ks))
    i32 = lambda x: jnp.asarray(x, jnp.int32)  # noqa: E731
    xs = (i32(sbs), i32(dbs), i32(src), i32(pos), i32(negs),
          jnp.full((steps,), 0.025, jnp.float32))

    def banded(wv, wc, sb, db, src, pos, negs, a, prec=SGNS_PRECISION):
        return sgns_shared_negs_step_banded(
            wv, wc, db, band, src, pos, negs, a, k_equiv=k_eq,
            src_band_start=sb, precision=prec)

    def plain(wv, wc, sb, db, src, pos, negs, a):
        return sgns_shared_negs_step(wv, wc, src, pos, negs, a, k_equiv=k_eq)

    ref_v, ref_c = numpy_sgns_step(wv0, wc0, src[0], pos[0], negs[0], 0.025,
                                   k_eq)
    for name, prec in (("production", SGNS_PRECISION),
                       ("HIGHEST", jax.lax.Precision.HIGHEST)):
        f = jax.jit(lambda *a, prec=prec: banded(*a, prec)[:2])
        got = f(jnp.asarray(wv0), jnp.asarray(wc0),
                *(x[0] for x in xs))
        for tab, g, r, w0, rows in (
                ("vertex", got[0], ref_v, wv0, src[0]),
                ("context", got[1], ref_c, wc0,
                 np.concatenate([pos[0], negs[0]]))):
            g, r, w0 = np.asarray(g)[rows], r[rows], w0[rows]
            dev = np.abs(g - r).max()
            rel, drel = dev / np.abs(r).max(), dev / np.abs(r - w0).max()
            log(f"banded step vs float64 reference, {name} precision, {tab}"
                f": max |diff| {dev:.3e} = {rel:.3e} of max |row|, "
                f"{drel:.3e} of max |update|")
            if prec == jax.lax.Precision.HIGHEST:
                assert rel < HIGHEST_RTOL, (name, tab, rel)
            else:
                assert drel < TF32_RTOL, (name, tab, drel)

    def scanned(fn):
        def run(tables, xs):
            def body(t, x):
                return fn(*t, *x)[:2], None
            return jax.lax.scan(body, tables, xs)[0]
        return jax.jit(run, donate_argnums=(0,))

    def tables():
        return jnp.asarray(wv0), jnp.asarray(wc0)

    times = {}
    for label, fn in (("banded", banded), ("unbanded", plain),
                      ("unbanded", plain), ("banded", banded)):
        f = scanned(fn)
        if label not in times:
            mem = f.lower(tables(), xs).compile().memory_analysis()
            log(f"{label} step: temp {mem.temp_size_in_bytes:,} B, "
                f"arguments {mem.argument_size_in_bytes:,} B, aliased "
                f"{mem.alias_size_in_bytes:,} B")
        times.setdefault(label, []).append(_time_steps(f, tables(), xs, 20))
    for label, ts in times.items():
        log(f"{label} step: {[round(t * 1e6, 1) for t in ts]} us per "
            f"micro-step (B={b}, D={d}, Ks={ks}, {n_pad:,} rows)")

    rc = pytest.main(["-q", "-p", "no:cacheprovider", "-p", "no:xdist",
                      "-m", "gpu",
                      os.path.join(HERE, "tests", "test_sgns_reference.py")])
    assert rc == 0, f"gpu-marked tests failed (pytest exit {rc})"


# ---------------------------------------------------------- phase 3/4 --
def _read_back(path: str, dim: int):
    """Check the interchange file (``N dim`` header, N rows) and load it
    by name with the program's own warm-start reader."""
    from smore_tpu.io.embeddings import warm_start

    with open(path, "rb") as f:
        header = f.readline().split()
        names = [line.split(b" ", 1)[0].decode() for line in f]
    assert len(header) == 2 and int(header[1]) == dim, header
    assert int(header[0]) == len(names), (header, len(names))
    table = warm_start(np.full((len(names), dim), np.nan, np.float32),
                       names, path)
    assert np.isfinite(table).all(), "non-finite or missing rows"
    return names, table


def run_line_cli(label, graph_path, labels, work, gate=None) -> None:
    import bench
    from smore_tpu.cli.main import main as cli

    out = os.path.join(work, f"{label}_emb.txt")
    argv = ["line", "-train", graph_path, "-save", out, "-order", "2",
            "-dimensions", "64", "-negative_samples", "5",
            "-sample_times", str(SAMPLE_TIMES)]
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        rc = cli(argv)
    wall = time.time() - t0
    text = buf.getvalue()
    log(text.replace("\r", "\n").strip().split("\n")[-1])
    assert rc in (0, None), f"CLI exit {rc}"
    step = re.search(r"step: ([^\n]*)", text).group(1)
    done = re.search(r"done: ([\d,]+) samples in ([\d.]+)s \(([\d,]+) "
                     r"samples/sec\)(?:; first call ([\d.]+)s .*?then "
                     r"([\d,]+) samples/sec)?", text)
    names, table = _read_back(out, 64)
    auc = bench.community_auc(table, names, labels)
    log(f"{label}: step [{step}]; {done.group(1)} samples, train "
        f"{done.group(2)} s ({done.group(3)} samples/s; first call "
        f"{done.group(4)} s, then {done.group(5)} samples/s); CLI wall "
        f"{wall:.1f} s; {len(names)} rows x 64 finite; community AUC "
        f"{auc:.4f}")
    if gate is not None:
        assert auc > gate, f"{label} community AUC {auc:.4f} <= {gate}"
    os.remove(out)


# -------------------------------------------------------- four cards --
def phase_four_cards(work) -> None:
    import jax

    import bench
    from smore_tpu.graph.graph import Graph
    from smore_tpu.models.line import LINE
    from smore_tpu.parallel.mesh import make_mesh

    assert len(jax.devices()) >= 4, jax.devices()
    path = os.path.join(work, "yt.txt")
    bench.make_youtube_graph(path)
    g = Graph.load_edge_list(path, undirected=True)
    mesh = make_mesh(4)
    results = {}
    for mode in ("one card", "hogwild", "rows"):
        m = LINE(g, seed=0)
        m.init(dim=64, order=2)
        kw = {} if mode == "one card" else dict(mesh=mesh, sharding=mode)
        m.train(sample_times=SAMPLE_TIMES, negative_samples=5, verbose=False,
                **kw)
        drv = m.last_driver
        wv = m.state["vertex"]
        if mode == "rows":
            shards = {s.device for s in wv.addressable_shards}
            rows = sorted(s.data.shape[0] for s in wv.addressable_shards)
            assert len(shards) == 4 and rows[-1] < wv.shape[0], (shards, rows)
            log(f"rows: vertex table {wv.shape} sharded over "
                f"{len(shards)} devices, shard rows {rows}")
        auc = bench.yt_community_auc(np.asarray(wv)[: g.n_vertices], g.names)
        results[mode] = auc
        log(f"{mode}: step [{m.step_name}], {drv.executed_samples:,} "
            f"samples in {drv.wall_s:.2f} s "
            f"({drv.executed_samples / drv.wall_s:,.0f} samples/s; first "
            f"call {drv.first_call_s:.2f} s, then "
            f"{drv.steady_samples_per_s or float('nan'):,.0f} samples/s); "
            f"community AUC {auc:.4f}")
        assert np.isfinite(np.asarray(wv)).all(), mode
    log("community AUC vs one card at the same total budget: " + ", ".join(
        f"{m} {results[m] - results['one card']:+.4f}"
        for m in ("hogwild", "rows")))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-device mesh phase")
    args = ap.parse_args(argv)

    devs = require_gpu()
    sys.path.insert(0, HERE)
    import bench

    phase_env(devs)
    with tempfile.TemporaryDirectory() as work:
        if args.four_cards:
            phase_four_cards(work)
        else:
            phase_step()
            yt = os.path.join(work, "yt.txt")
            bench.make_youtube_graph(yt)
            run_line_cli("youtube-shaped 1.1M", yt, bench.yt_labels(), work,
                         gate=YT_AUC_GATE)
            small = os.path.join(work, "comm50k.txt")
            bench.make_graph(small)
            run_line_cli("community 50k", small, bench.graph_labels(), work)
    log(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
