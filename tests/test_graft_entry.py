"""The driver's entry points must stay importable and runnable: entry()
is compile-checked on one device, dryrun_multichip(n) validates
the production multi-chip sharding on a virtual CPU mesh."""

import sys
import os

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_entry_jits_and_runs():
    import __graft_entry__ as g

    fn, args = g.entry()
    out, loss = jax.jit(fn)(*args)
    assert set(out) == {"vertex", "context"}
    assert all(v.shape == (256, 32) for v in out.values())
    assert jax.numpy.isfinite(loss).all()


def test_dryrun_multichip_8():
    import __graft_entry__ as g

    # exercises the dp, rows (GSPMD row-sharded) and hogwild (banded
    # step) mesh modes; raises on failure
    g.dryrun_multichip(8)
