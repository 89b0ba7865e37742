"""Per-kernel GPU microbenchmarks: compile time + steady-state time +
roofline placement (BASELINE.md reporting row: "BA/matching kernels
benchmarked vs roofline").

Times the engine's hot device programs one at a time at production
shapes (640x480, preset "default"):
  pyramid_xla                  — the per-frame pyramid build
  fused_step                   — pyramid+track+trace single dispatch
  track_step                   — pyramid+track (pipelined mode)
  trace_step                   — epipolar trace of the immature bank
  ba_gn_step                   — one windowed-BA Gauss-Newton iteration

For each kernel the FLOP and byte counts come from XLA's own cost model
(compiled.cost_analysis()); against the card's peak FLOP rate and
memory bandwidth this yields arithmetic intensity, the speed-of-light
time for each resource, which resource BOUNDS the kernel, and the
achieved fraction of that bound (pct_of_roofline).

Usage: python scripts/bench_kernels.py [kernel ...]   (default: all)
Needs a GPU whose ``device_kind`` is in ``CHIP_SPECS``.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

# Peak rates by jax ``device_kind``: (name, float32 TFLOP/s without
# tensor cores, TF32 tensor-core TFLOP/s, memory GB/s). Source: NVIDIA
# H100 data sheet, SXM part, dense rates at the 700 W power limit. The
# engine pins Precision.HIGHEST, so its FLOP ceiling is the float32 rate.
CHIP_SPECS = {
    "NVIDIA H100 80GB HBM3": ("H100 SXM", 67.0, 495.0, 3350.0),
}


def chip_spec(kind=None):
    """Peak table row for ``kind`` (default: the first JAX device's)."""
    if kind is None:
        import jax

        kind = jax.devices()[0].device_kind
    if kind not in CHIP_SPECS:
        raise KeyError(f"no peak rates for device_kind {kind!r}; add its "
                       f"data-sheet row to CHIP_SPECS")
    return CHIP_SPECS[kind]


def cost_of(run, args, out):
    """(flops, bytes_xla, bytes_io) for a jitted callable.

    flops / bytes_xla come from XLA's cost model; bytes_xla counts every
    op's operands PRE-fusion, so it OVERSTATES HBM traffic (fused
    intermediates never reach device memory) — an upper bound. bytes_io is the
    sum of the argument + result array sizes: the cold-miss floor every
    launch must move through device memory at least once — a lower bound. True
    traffic lies in between; the roofline below uses bytes_io (i.e. the
    optimistic/speed-of-light bound)."""
    import jax

    c = run.lower(*args).compile().cost_analysis()
    if isinstance(c, (list, tuple)):
        c = c[0]
    fl = float(c.get("flops", 0.0))
    by_xla = float(c.get("bytes accessed", 0.0))
    by_io = 0.0
    for leaf in jax.tree_util.tree_leaves((args, out)):
        if hasattr(leaf, "nbytes"):
            by_io += float(leaf.nbytes)
    if fl <= 0 and by_io <= 0:
        return None
    return fl, by_xla, by_io


def timed(name, build, run, n=20):
    """build() -> args for run(); times first call (compile) + steady,
    then places the kernel on the card's roofline."""
    args = build()
    t0 = time.perf_counter()
    out = run(*args)
    import jax
    jax.block_until_ready(out)
    t_compile = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(n):
        out = run(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / n

    rec = dict(kernel=name, compile_s=round(t_compile, 2),
               steady_ms=round(1e3 * dt, 3))
    cost = cost_of(run, args, out)
    if cost is not None:
        chip, tflops, _, gbps = chip_spec()
        flops, by_xla, by_io = cost
        t_flop = flops / (tflops * 1e12)          # speed-of-light compute s
        t_io = by_io / (gbps * 1e9)               # SoL memory s (IO floor)
        t_xla = by_xla / (gbps * 1e9)             # memory s if nothing fused
        sol = max(t_flop, t_io)
        rec.update(
            chip=chip,
            gflops=round(flops / 1e9, 3),
            mbytes_io=round(by_io / 1e6, 3),
            mbytes_xla=round(by_xla / 1e6, 3),
            arith_intensity=round(flops / max(by_io, 1.0), 2),
            # a kernel far from BOTH ceilings is bound by neither — it is
            # serialized small-op / gather latency (scan iterations)
            bound=("flops" if t_flop >= t_io else "memory")
            if sol / dt > 0.15 else "latency",
            sol_ms=round(1e3 * sol, 3),           # roofline-limit time
            pct_of_roofline=round(100.0 * sol / dt, 1),
            flop_util_pct=round(100.0 * t_flop / dt, 1),
            mem_util_pct=round(100.0 * t_io / dt, 1),
            mem_util_unfused_pct=round(100.0 * t_xla / dt, 1),
        )
    print(json.dumps(rec), flush=True)
    return dt


def main(which):
    import jax
    import jax.numpy as jnp

    from ldso_tpu.config import preset
    from ldso_tpu.core import bank as bank_mod
    from ldso_tpu import frame_step, tracker
    from ldso_tpu.kernels import pyramid as pyr_mod

    cfg = preset("default")
    w, h = 640, 480
    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.random((h, w), np.float32) * 255.0)
    L = cfg.shapes.pyr_levels

    if "pyramid_xla" in which:
        f = jax.jit(lambda x: pyr_mod.build_pyramid(x, L))
        timed("pyramid_xla", lambda: (img,), f)

    # common tracking inputs
    def make_ref():
        n = cfg.shapes.track_points
        uv = jnp.asarray(
            rng.uniform([8, 8], [w - 8, h - 8], (n, 2)).astype(np.float32))
        idep = jnp.asarray(rng.uniform(0.2, 2.0, n).astype(np.float32))
        col = jnp.asarray(rng.uniform(30, 220, n).astype(np.float32))
        val = jnp.ones(n, bool)
        return tracker.make_tracker_ref(uv, idep, col, val, L)

    intr_host = np.asarray([0.88 * w, 0.88 * w, w / 2 - 0.5, h / 2 - 0.5],
                           np.float32)
    intr = jnp.asarray(intr_host)
    eye = jnp.eye(4, dtype=jnp.float32)

    def make_bank():
        b = bank_mod.empty_bank(cfg.shapes.max_immature)
        n = cfg.shapes.max_immature
        return b._replace(
            valid=jnp.ones(n, bool),
            host_slot=jnp.zeros(n, jnp.int32),
            uv=jnp.asarray(rng.uniform([8, 8], [w - 8, h - 8], (n, 2)),
                           jnp.float32),
            color=jnp.asarray(rng.uniform(30, 220, (n, 8)), jnp.float32),
            idepth_min=jnp.full(n, 0.1, jnp.float32),
            idepth_max=jnp.full(n, 2.0, jnp.float32))

    if "track_step" in which or "fused_step" in which or "trace_step" in which:
        from ldso_tpu.core import window as win_mod
        win = win_mod.empty_window(cfg, h, w, intr_host)
        ref = make_ref()
        bank = make_bank()
        ab0 = jnp.zeros(2, jnp.float32)
        if "track_step" in which:
            timed("track_step",
                  lambda: (img, ref, eye, eye, ab0, intr, jnp.float32(1.0), cfg),
                  frame_step.track_step)
        if "trace_step" in which:
            img3 = jnp.stack([img, img, img], axis=-1)
            timed("trace_step",
                  lambda: (img3, bank, win.T_eval, win.x, win.exposure,
                           eye, ab0, jnp.float32(1.0), intr, cfg),
                  frame_step.trace_step)
        if "fused_step" in which:
            timed("fused_step",
                  lambda: (img, ref, eye, eye, ab0, bank, win.T_eval, win.x,
                           win.exposure, eye, intr, jnp.float32(1.0), cfg),
                  frame_step.fused_step)

    if "ba_gn_step" in which:
        from ldso_tpu.ba.residuals import assemble
        from ldso_tpu.ba.solve import (apply_step, _solve_core, fix_mask,
                                       prior_diag, prior_offset, scale_vector)
        from ldso_tpu.core.window import state_delta
        from ldso_tpu.eval.toys import make_synthetic_window

        win, _ = make_synthetic_window(cfg, w=w, h=h, n_frames=6,
                                       idepth_noise=0.05, pose_noise=0.003)
        F = cfg.shapes.max_frames
        D = cfg.shapes.state_dim
        # frame_valid is known host-side (n_frames=6)
        valid_host = np.arange(F) < 6
        prior_d = jnp.asarray(prior_diag(valid_host, cfg), jnp.float32)
        s_vec = jnp.asarray(scale_vector(F, cfg.scales))
        fixed = jnp.asarray(fix_mask(F, 0))
        HM = jnp.zeros((D, D), jnp.float32)
        bM = jnp.zeros(D, jnp.float32)

        @jax.jit
        def gn(win):
            sys_ = assemble(win, huber_th=cfg.ba.huber_th,
                            outlier_sum=cfg.ba.outlier_th_sum_component)
            dx, dd = _solve_core(
                sys_.H, sys_.b, sys_.H_xd, sys_.H_dd, sys_.b_d,
                HM, bM, state_delta(win), prior_d, s_vec, fixed,
                jnp.zeros(D, jnp.float32), jnp.float32(1e-5), win.p_valid,
                prior_off=prior_offset(win))
            return apply_step(win, dx, dd)

        timed("ba_gn_step", lambda: (win,), gn)


if __name__ == "__main__":
    which = sys.argv[1:] or ["pyramid_xla", "track_step",
                             "trace_step", "fused_step", "ba_gn_step"]
    main(which)
