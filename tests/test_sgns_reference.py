"""The shared-negative SGNS steps at production widths (D = 64 / 128,
Ks = 128) against a float64 NumPy reference of the same update, with
repeated rows (XLA scatter-adds sum them, like the reference's hogwild
threads applying every update)."""

import jax.numpy as jnp
import numpy as np
import pytest

from smore_tpu.ops.update import (
    sgns_shared_negs_step,
    sgns_shared_negs_step_banded,
)

N, BAND, B, KS, K_EQUIV, ALPHA = 512, 128, 256, 128, 5, 0.05


def _sig(x):
    return 1.0 / (1.0 + np.exp(-x))


def _numpy_step(wv, wc, src, pos, negs, shared):
    wv = wv.astype(np.float64)
    wc = wv if shared else wc.astype(np.float64)
    v, cp, cn = wv[src], wc[pos], wc[negs]
    g_pos = (1.0 - _sig((v * cp).sum(1))) * ALPHA
    g_neg = -_sig(v @ cn.T) * ALPHA * K_EQUIV / len(negs)
    d_src = g_pos[:, None] * cp + g_neg @ cn
    d_pos = g_pos[:, None] * v
    d_neg = g_neg.T @ v
    out_c = wc.copy()
    np.add.at(out_c, pos, d_pos)
    np.add.at(out_c, negs, d_neg)
    out_v = out_c if shared else wv.copy()
    np.add.at(out_v, src, d_src)
    return out_v, out_c


def _draw(dim, seed, src_band):
    rng = np.random.default_rng(seed)
    wv = rng.normal(0, 0.1, (N, dim)).astype(np.float32)
    wc = rng.normal(0, 0.1, (N, dim)).astype(np.float32)
    lo = BAND if src_band else 0
    hi = 2 * BAND if src_band else N
    src = rng.integers(lo, hi, B)  # repeats: B rows from <= BAND values
    pos = rng.integers(2 * BAND, 3 * BAND, B)  # all in the third band
    negs = rng.integers(0, N, KS)
    return wv, wc, src, pos, negs


@pytest.mark.parametrize("dim", [64, 128])
@pytest.mark.parametrize("step", ["plain", "banded_2d", "banded_order1"])
def test_xla_step_matches_numpy(dim, step):
    shared = step == "banded_order1"
    wv, wc, src, pos, negs = _draw(dim, seed=dim, src_band=step == "banded_2d")
    j = [jnp.asarray(x) for x in (wv, wc)] + [
        jnp.asarray(x, jnp.int32) for x in (src, pos, negs)]
    a = jnp.float32(ALPHA)
    if step == "plain":
        gv, gc, _ = sgns_shared_negs_step(*j, a, k_equiv=K_EQUIV)
    elif step == "banded_2d":
        gv, gc, _ = sgns_shared_negs_step_banded(
            j[0], j[1], jnp.int32(2 * BAND), BAND, *j[2:], a,
            k_equiv=K_EQUIV, src_band_start=jnp.int32(BAND))
    else:
        gv, gc, _ = sgns_shared_negs_step_banded(
            j[0], j[0], jnp.int32(2 * BAND), BAND, *j[2:], a,
            k_equiv=K_EQUIV, shared_table=True)
    rv, rc = _numpy_step(wv, wc, src, pos, negs, shared)
    np.testing.assert_allclose(gv, rv, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gc, rc, rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("precision,rtol", [("highest", 1e-5),
                                            ("production", 1e-2)])
def test_banded_step_on_gpu_at_youtube_widths(gpu, precision, rtol):
    """The compiled banded step on the card at Youtube widths (1.1M rows,
    D=64, B=32768, Ks=128, hub rows repeated) against the float64
    reference. At HIGHEST only float32 summation order differs (1e-5 of
    the largest updated row); at the production precision the dots may
    run as TF32 (~1e-3 relative per product: 1e-2 of the largest
    update)."""
    import jax

    from smore_tpu.ops.update import SGNS_PRECISION

    n, band, b, d = 1_114_384, 32776, 32768, 64
    rng = np.random.default_rng(7)
    wv = rng.normal(0, 0.1, (n, d)).astype(np.float32)
    wc = rng.normal(0, 0.1, (n, d)).astype(np.float32)
    p = 1.0 / np.arange(1, band + 1) ** 0.8
    src = 3 * band + rng.choice(band, b, p=p / p.sum())
    pos = 20 * band + rng.choice(band, b, p=p / p.sum())
    negs = rng.integers(0, n, KS)
    prec = (jax.lax.Precision.HIGHEST if precision == "highest"
            else SGNS_PRECISION)
    gv, gc, _ = jax.jit(
        lambda wv, wc, s, p, ng: sgns_shared_negs_step_banded(
            wv, wc, jnp.int32(20 * band), band, s, p, ng,
            jnp.float32(ALPHA), k_equiv=K_EQUIV,
            src_band_start=jnp.int32(3 * band), precision=prec),
    )(jnp.asarray(wv), jnp.asarray(wc),
      *(jnp.asarray(x, jnp.int32) for x in (src, pos, negs)))
    rv, rc = _numpy_step(wv, wc, src, pos, negs, shared=False)
    for got, ref, w0, rows in ((gv, rv, wv, src),
                               (gc, rc, wc, np.concatenate([pos, negs]))):
        got = np.asarray(got)[rows]
        dev = np.abs(got - ref[rows]).max()
        scale = (np.abs(ref[rows]).max() if precision == "highest"
                 else np.abs(ref[rows] - w0[rows]).max())
        assert dev < rtol * scale, (dev, scale)
