"""Process set-up: where the compile cache goes, that the model zoo
imports without flax, and the NumPy checkpoint format."""

import os
import subprocess
import sys

import numpy as np
import pytest

from smore_tpu.utils.checkpoint import (
    checkpoint_exists,
    load_checkpoint,
    save_checkpoint,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, **env):
    e = {k: v for k, v in os.environ.items()
         if k != "JAX_COMPILATION_CACHE_DIR"}
    e.update(env, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=e, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


@pytest.mark.parametrize("env_dir", [None, "elsewhere"])
def test_compile_cache_dir(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache sits
    at a fixed .jax_cache in the checkout (never in the home directory)."""
    env = {}
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    got = _run("import jax, smore_tpu; "
               "print(jax.config.jax_compilation_cache_dir)", **env)
    want = env.get("JAX_COMPILATION_CACHE_DIR",
                   os.path.join(REPO, ".jax_cache"))
    assert got == want


def test_models_import_without_flax():
    got = _run(
        "import sys; sys.modules['flax'] = None\n"
        "import smore_tpu.models as M\n"
        "from smore_tpu.cli.main import main\n"
        "print(M.LINE.__name__, 'flax' in sys.modules and "
        "sys.modules['flax'] is not None)\n"
        "try:\n"
        "    M.SASRec\n"
        "except ImportError:\n"
        "    print('lazy')\n"
    )
    assert got.split("\n") == ["LINE False", "lazy"]


@pytest.mark.parametrize("payload", [
    {"vertex": np.arange(12, dtype=np.float32).reshape(3, 4)},
    {"s": {"user_static": np.ones((2, 3), np.float32),
           "item_static": np.zeros((4, 3), np.float32)},
     "ue": np.full((2, 3), 0.5, np.float32)},
])
def test_checkpoint_round_trip(tmp_path, payload):
    path = str(tmp_path / "ckpt")
    assert not checkpoint_exists(path)
    key = np.array([[1, 2], [3, 4]], np.uint32)
    save_checkpoint(path, payload, step=7, extra={"key": key, "epochs": 3})
    assert checkpoint_exists(path)
    state, step, extra = load_checkpoint(path)
    assert step == 7 and int(extra["epochs"]) == 3
    np.testing.assert_array_equal(extra["key"], key)
    assert extra["key"].dtype == np.uint32

    def same(a, b):
        assert set(a) == set(b)
        for k in a:
            if isinstance(a[k], dict):
                same(a[k], b[k])
            else:
                np.testing.assert_array_equal(a[k], b[k])
                assert a[k].dtype == b[k].dtype

    same(state, payload)


def test_checkpoint_overwrite_keeps_latest(tmp_path):
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, {"w": np.zeros(3)}, step=1)
    save_checkpoint(path, {"w": np.ones(3)}, step=2)
    state, step, extra = load_checkpoint(path)
    assert step == 2 and extra is None
    np.testing.assert_array_equal(state["w"], np.ones(3))
    assert os.listdir(path) == ["checkpoint.npz"]
