"""ATE probe: run the test_system 30-frame synthetic sequence with
optional behavior toggles (env vars) and print the ATE%% — the bisect
harness for drift regressions.

Usage: JAX_PLATFORMS=cpu python scripts/ate_probe.py
Toggles (env): LDSO_NO_DECIMATE=1  LDSO_NO_EARLYBREAK=1  LDSO_FIXED_MAD=1
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("LDSO_NO_COMPILE_CACHE", "1")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
if os.environ.get("LDSO_PROBE_X64", "1") == "1":
    jax.config.update("jax_enable_x64", True)   # match tests/conftest.py

import numpy as np  # noqa: E402

from ldso_tpu.config import preset
from ldso_tpu.eval.ate import ate_rmse
from ldso_tpu.io.synthetic import SyntheticDataset
from ldso_tpu.system import FullSystem


def run_ate(cfg=None, n=30, w=320, h=240, seed=0, with_loop=True):
    from ldso_tpu.loop.closing import LoopClosing

    cfg = cfg or preset("tiny")
    ds = SyntheticDataset(w=w, h=h, n=n, traj_kind="forward_arc", seed=seed)
    system = FullSystem(cfg, ds.intrinsics(), ds.w, ds.h)
    if with_loop:
        lc = LoopClosing(cfg, ds.intrinsics(), train_after=3)
        system.on_keyframe = lc.on_keyframe
        system.loop_closing = lc
    for i in range(ds.num_frames):
        img, ts, exp = ds.get_image(i)
        st = system.add_frame(img, ts, exp)
        if st["status"] == "lost":
            print(f"LOST at frame {i}: {st}")
            return float("nan"), system
    ts_, poses = system.export_trajectory()
    ids = [fr.frame_id for fr in system.frames][: len(poses)]
    gt = np.stack([ds.gt_pose_c_w(i) for i in ids])
    est_c = np.stack([-(P[:3, :3].T @ P[:3, 3]) for P in poses])
    gt_c = np.stack([-(P[:3, :3].T @ P[:3, 3]) for P in gt])
    rmse, _ = ate_rmse(est_c, gt_c, with_scale=True)
    extent = np.linalg.norm(gt_c.max(0) - gt_c.min(0))
    return 100.0 * rmse / extent, system


def _apply_toggles(cfg):
    import dataclasses

    if os.environ.get("LDSO_NO_EARLYBREAK") == "1":
        cfg = cfg.replace(tracker=dataclasses.replace(
            cfg.tracker, step_eps=0.0))
    if os.environ.get("LDSO_ZERO_MAD") == "1":
        cfg = cfg.replace(selector=dataclasses.replace(
            cfg.selector, min_act_dist=0.0))
    if os.environ.get("LDSO_NO_CORNERS") == "1":
        cfg = cfg.replace(selector=dataclasses.replace(
            cfg.selector, corner_fraction=0.0))
    if os.environ.get("LDSO_OLD_AFF_PRIOR") == "1":
        cfg = cfg.replace(ba=dataclasses.replace(
            cfg.ba, affine_prior_a=1e3, affine_prior_b=1e1))
    if os.environ.get("LDSO_MORE_BA") == "1":
        cfg = cfg.replace(ba=dataclasses.replace(
            cfg.ba, max_iterations=cfg.ba.max_iterations * 2))
    if os.environ.get("LDSO_MAD"):
        cfg = cfg.replace(selector=dataclasses.replace(
            cfg.selector, min_act_dist=float(os.environ["LDSO_MAD"])))
    if os.environ.get("LDSO_BA_REJECT") == "1":
        # round-2 change probe: host-driven energy-accept/reject λ ladder
        # instead of the fused force-accept device loop
        from ldso_tpu.ba import solve as solve_mod
        import ldso_tpu.system as sysmod

        orig = solve_mod.run_ba

        def run_ba_reject(win, HM, bM, cfg, anchor_slot=0, device_loop=True):
            return orig(win, HM, bM, cfg, anchor_slot=anchor_slot,
                        device_loop=False)

        solve_mod.run_ba = run_ba_reject
        sysmod.solve.run_ba = run_ba_reject
    if os.environ.get("LDSO_SWEEP"):
        cfg = cfg.replace(trace=dataclasses.replace(
            cfg.trace, sweep_pattern=int(os.environ["LDSO_SWEEP"])))
    if os.environ.get("LDSO_EPI"):
        cfg = cfg.replace(shapes=dataclasses.replace(
            cfg.shapes, epi_samples=int(os.environ["LDSO_EPI"])))
    if os.environ.get("LDSO_STEP_EPS"):
        cfg = cfg.replace(tracker=dataclasses.replace(
            cfg.tracker, step_eps=float(os.environ["LDSO_STEP_EPS"])))
    if os.environ.get("LDSO_TRACK_ITERS"):
        # probe: scale the per-level tracker iteration budgets
        import dataclasses as _dc
        f = float(os.environ["LDSO_TRACK_ITERS"])
        its = tuple(max(2, int(round(v * f))) for v in cfg.tracker.max_iterations)
        cfg = cfg.replace(tracker=_dc.replace(cfg.tracker, max_iterations=its))
    if os.environ.get("LDSO_NO_DECIMATE") == "1":
        from ldso_tpu import tracker as trk

        orig = trk.make_tracker_ref.__wrapped__ \
            if hasattr(trk.make_tracker_ref, "__wrapped__") \
            else trk.make_tracker_ref

        def full_ref(uv, idep, color, valid, levels, exposure=1.0,
                     aff_ab=(0.0, 0.0)):
            import jax.numpy as jnp
            uvs, ids, cols, vals = [], [], [], []
            for l in range(levels):
                s = 0.5 ** l
                uvs.append(uv * s + (0.5 * s - 0.5))
                ids.append(idep)
                cols.append(color)
                vals.append(valid)
            return trk.TrackerRef(uv=tuple(uvs), idepth=tuple(ids),
                                  color=tuple(cols), valid=tuple(vals),
                                  exposure=jnp.asarray(exposure, jnp.float32),
                                  aff_ab=jnp.asarray(aff_ab, jnp.float32))

        trk.make_tracker_ref = full_ref
        import ldso_tpu.system as sysmod
        sysmod.tracker.make_tracker_ref = full_ref
    return cfg


if __name__ == "__main__":
    cfg = _apply_toggles(preset("tiny"))
    pct, _ = run_ate(cfg=cfg)
    print(f"ATE {pct:.3f}% of extent")
