"""ldso_tpu — a monocular direct-sparse SLAM engine in JAX.

A from-scratch JAX/XLA re-design of the capabilities of LDSO
(Direct Sparse Odometry with Loop Closure, reference: n-lalanne/LDSO):
pyramidal direct image alignment, sliding-window photometric bundle
adjustment with Schur-complement marginalization and First-Estimate
Jacobians, corner-biased point selection with ORB-style descriptors,
bag-of-words loop detection, and global Sim(3) pose-graph optimization.

Design stance (see SURVEY.md §7.0):
  * functional core / imperative shell — all numerics are pure jitted
    functions over pytrees; a thin host conductor owns the frame loop.
  * static shapes everywhere — fixed capacities + validity masks.
  * the windowed BA reduces to a handful of dense products plus a tiny
    dense solve, and shards over a device mesh with one psum per
    Gauss-Newton iteration.
  * true float32 products: every matrix product pins
    ``Precision.HIGHEST``, so a GPU never rounds operands to TF32.
"""

__version__ = "0.1.0"

import os as _os

_REPO_ROOT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))


def compile_cache_dir(environ=_os.environ):
    """Where the persistent compilation cache lives, or None for none.

    ``JAX_COMPILATION_CACHE_DIR`` wins when set; otherwise the cache is
    ``<repo>/.jax_cache``, a fixed path inside the checkout (the path is
    part of the cache key, so it must not move between runs). Processes
    held to the CPU (``JAX_PLATFORMS=cpu``) and ``LDSO_NO_COMPILE_CACHE=1``
    get none: XLA:CPU entries embed host machine features and save little.
    """
    if environ.get("LDSO_NO_COMPILE_CACHE"):
        return None
    platforms = environ.get("JAX_PLATFORMS", "").lower().split(",")
    if [p.strip() for p in platforms] == ["cpu"]:
        return None
    return environ.get("JAX_COMPILATION_CACHE_DIR") or \
        _os.path.join(_REPO_ROOT, ".jax_cache")


def _setup_compile_cache():
    path = compile_cache_dir()
    if path is None:
        return
    import jax

    _os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


_setup_compile_cache()
