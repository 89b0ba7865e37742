"""Targeted latency profile of the tracking/tracing chain on the device.

Measures, at production shapes with REALISTIC (synthetic-scene) imagery
and small inter-frame motion:
  * track_step total, coarse-ladder stage alone, each fine level alone
  * actual LM iteration counts per level (the while_loop early-exit
    behavior under a good constant-velocity prior)
  * marginal per-iteration cost of track_level
  * trace_step total

Usage: python scripts/prof_track.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from ldso_tpu.config import preset
from ldso_tpu import frame_step, tracker
from ldso_tpu.cameras import level_intrinsics
from ldso_tpu.core import bank as bank_mod
from ldso_tpu.core import window as win_mod
from ldso_tpu.io.synthetic import SyntheticDataset
from ldso_tpu.kernels.pyramid import build_pyramid


def t_ms(fn, *args, n=20):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return 1e3 * (time.perf_counter() - t0) / n, out


def main():
    cfg = preset("default")
    ds = SyntheticDataset(w=640, h=480, n=4)
    w, h = ds.w, ds.h
    intr = jnp.asarray(ds.intrinsics(), jnp.float32)
    L = cfg.shapes.pyr_levels
    img0 = np.asarray(ds.get_image(0)[0], np.float32)
    img1 = np.asarray(ds.get_image(1)[0], np.float32)
    m = 1 << (L - 1)
    img0 = img0[: (h // m) * m, : (w // m) * m]
    img1 = img1[: (h // m) * m, : (w // m) * m]
    h, w = img0.shape

    pyr0, _ = build_pyramid(jnp.asarray(img0), L)
    pyr1, _ = build_pyramid(jnp.asarray(img1), L)

    # reference point set from ground-truth idepth of frame 0
    idep_full = ds.get_idepth(0)[:h, :w]
    rng = np.random.default_rng(0)
    n = cfg.shapes.track_points
    uv = rng.uniform([8, 8], [w - 8, h - 8], (n, 2)).astype(np.float32)
    iy, ix = uv[:, 1].astype(int), uv[:, 0].astype(int)
    idep = idep_full[iy, ix].astype(np.float32)
    col = img0[iy, ix].astype(np.float32)
    ref = tracker.make_tracker_ref(jnp.asarray(uv), jnp.asarray(idep),
                                   jnp.asarray(col), jnp.ones(n, bool), L)
    jax.block_until_ready(ref)

    # ground-truth relative pose 0->1 as the const-velocity carry
    T0 = ds.gt_pose_c_w(0)
    T1 = ds.gt_pose_c_w(1)
    T_rel = (T1 @ np.linalg.inv(T0)).astype(np.float32)
    eye = jnp.eye(4, dtype=jnp.float32)
    T_last = jnp.asarray(T_rel)     # perfect prior: const-vel is right
    ab0 = jnp.zeros(2, jnp.float32)

    dt, _ = t_ms(frame_step.track_step, jnp.asarray(img1), ref, T_last,
                 T_last, ab0, intr, jnp.float32(1.0), cfg)
    print(f"track_step total (good prior): {dt:.2f} ms")

    dt, _ = t_ms(frame_step.track_step, jnp.asarray(img1), ref, eye,
                 eye, ab0, intr, jnp.float32(1.0), cfg)
    print(f"track_step total (identity prior): {dt:.2f} ms")

    # pyramid alone
    dt, _ = t_ms(jax.jit(lambda x: build_pyramid(x, L)), jnp.asarray(img1))
    print(f"pyramid: {dt:.2f} ms")

    # instrumented per-level track_level: iteration counts + time
    tcfg = cfg.tracker
    iters_sched = list(tcfg.max_iterations) + [50] * L

    def level_fn(l, iters, K=None):
        intr_l = level_intrinsics(intr, l)
        hh, ww = pyr1[l].shape[0], pyr1[l].shape[1]

        def run(T0_, ab0_):
            return tracker.track_level(
                pyr1[l], ref.uv[l], ref.idepth[l], ref.color[l], ref.valid[l],
                T0_, ab0_, intr_l, ww, hh, iters,
                float(tcfg.coarse_cutoff_th * 2.0 ** l), float(tcfg.huber_th),
                lam0=float(tcfg.lambda_initial),
                lam_success=float(tcfg.lambda_success),
                lam_fail=float(tcfg.lambda_fail),
                step_eps=float(tcfg.step_eps))
        if K:
            return jax.jit(jax.vmap(run))
        return jax.jit(run)

    # coarse ladder: levels L-1, L-2 vmapped over 27 hyps
    K = cfg.shapes.num_hypotheses
    hyps = tracker.motion_hypotheses(T_last, num=K)
    abK = jnp.broadcast_to(ab0, (K, 2))
    for l in (L - 1, L - 2):
        f = level_fn(l, min(int(iters_sched[l]), 12), K=K)
        dt, out = t_ms(f, hyps, abK)
        print(f"  ladder level {l} (27 hyp, <=12 it): {dt:.2f} ms")
    # fine levels sequential from good prior
    T, ab = jnp.asarray(T_rel), ab0
    for l in range(L - 3, -1, -1):
        f = level_fn(l, int(iters_sched[l]))
        dt, out = t_ms(f, T, ab)
        T, ab = out[0], out[1]
        print(f"  fine level {l} (<= {iters_sched[l]} it): {dt:.2f} ms")

    # marginal per-iteration cost at level 0 and level 3
    for l, base in ((0, 2), (3, 2)):
        f1 = level_fn(l, base)
        f2 = level_fn(l, base + 10)
        d1, _ = t_ms(f1, eye, ab0)
        d2, _ = t_ms(f2, eye, ab0)
        print(f"  level {l}: {base} it = {d1:.2f} ms, {base+10} it = {d2:.2f} ms"
              f" -> {100*(d2-d1)/10:.0f} us/iter")

    # trace_step
    win = win_mod.empty_window(cfg, h, w, np.asarray(intr))
    nb = cfg.shapes.max_immature
    bank = bank_mod.empty_bank(nb)._replace(
        valid=jnp.ones(nb, bool),
        host_slot=jnp.zeros(nb, jnp.int32),
        uv=jnp.asarray(rng.uniform([8, 8], [w - 8, h - 8], (nb, 2)), jnp.float32),
        color=jnp.asarray(rng.uniform(30, 220, (nb, 8)), jnp.float32),
        idepth_min=jnp.full(nb, 0.1, jnp.float32),
        idepth_max=jnp.full(nb, 2.0, jnp.float32))
    img3 = pyr1[0]
    dt, _ = t_ms(frame_step.trace_step, img3, bank, win.T_eval, win.x,
                 win.exposure, jnp.asarray(T_rel), ab0, jnp.float32(1.0),
                 intr, cfg)
    print(f"trace_step: {dt:.2f} ms")


if __name__ == "__main__":
    main()
