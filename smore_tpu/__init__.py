"""smore-tpu: a JAX graph-embedding framework.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of SMORe
(RainBoltz/smore): sampling-based weighted-graph embedding with pluggable
samplers, walk/pair mappers, and SGD loss kernels over shared embedding
tables.

Architecture (vs. the reference's single-node hogwild CPU engine):

- Graph storage and loaders are host-side (numpy CSR + C++ native parsing).
- Alias tables are built once on host, then live on-device; every draw
  (source, per-vertex context, negative, walk step) is a batched gather
  inside the jitted training step -- there is no per-sample host loop.
- All ~25 reference SGD kernels (``proNet::Opt_*`` / ``Update*``,
  /root/reference/src/proNet.cpp:991-3371) collapse into fused
  gather->dot->loss-grad->scatter-add steps parameterized by loss.
- Multi-device scaling uses ``jax.sharding`` meshes (data-parallel sampling
  with replicated or row-sharded tables) instead of OpenMP threads.
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# Persistent XLA compilation cache: JAX_COMPILATION_CACHE_DIR when it is
# set (JAX reads it itself), else a fixed directory in the checkout, so
# the cache never crosses hosts and its path stays stable between runs.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(
            _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
            ".jax_cache",
        ),
    )
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from smore_tpu.graph.graph import Graph  # noqa: F401
