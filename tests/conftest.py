"""Test configuration: force CPU with 8 virtual devices so multi-device
sharding paths can be exercised without accelerator hardware (SURVEY.md
section 4). Tests marked ``gpu`` need the card and skip here;
``python chip_smoke.py`` runs them on a GPU, in its own process, whose
backend is set before this file is imported.

Must run before jax is imported anywhere in the test process.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax
import numpy as np
import pytest


TOY_EDGES = [
    ("userA", "itemA", 3.0),
    ("userA", "itemC", 5.0),
    ("userB", "itemA", 1.0),
    ("userB", "itemB", 5.0),
    ("userC", "itemA", 4.0),
]


@pytest.fixture
def toy_net_path(tmp_path):
    """The README toy user-item net (/root/reference/README.md:49-56)."""
    p = tmp_path / "net.txt"
    p.write_text("".join(f"{a} {b} {int(w)}\n" for a, b, w in TOY_EDGES))
    return str(p)


@pytest.fixture
def toy_graph():
    from smore_tpu.graph.graph import Graph

    return Graph.from_edges(TOY_EDGES, undirected=True)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """For tests marked ``gpu``: skip unless JAX's default backend is a
    GPU. Decided here, at run time, never while the module is imported."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (compiled Pallas-Triton kernel)")
