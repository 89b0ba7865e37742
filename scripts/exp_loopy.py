"""Calibration experiment for the loop-closure validation suite:
out-and-back synthetic trajectory, with and without loop closing,
reporting ATE / loop count / marginalization stats. CPU-runnable.

Usage: JAX_PLATFORMS=cpu python scripts/exp_loopy.py [n_frames]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, "/root/repo")

os.environ.setdefault("LDSO_NO_COMPILE_CACHE", "1")
if os.environ.get("LDSO_PLATFORM", "cpu") == "cpu":
    import jax
    jax.config.update("jax_platforms", "cpu")

from ldso_tpu.config import preset
from ldso_tpu.eval.ate import ate_rmse
from ldso_tpu.io.synthetic import SyntheticDataset
from ldso_tpu.system import FullSystem


def run(n, loop_closing: bool, seed=0, traj="out_and_back", verbose=False):
    from ldso_tpu.loop.closing import LoopClosing

    cfg = preset("tiny")
    ds = SyntheticDataset(w=320, h=240, n=n, traj_kind=traj, seed=seed)
    system = FullSystem(cfg, ds.intrinsics(), ds.w, ds.h)
    lc = None
    if loop_closing:
        lc = LoopClosing(cfg, ds.intrinsics(), train_after=4)
        system.on_keyframe = lc.on_keyframe
        system.loop_closing = lc
    t0 = time.time()
    hist = []
    for i in range(n):
        img, ts, exp = ds.get_image(i)
        st = system.add_frame(img, ts, exp)
        hist.append(st)
        if verbose and st.get("need_kf"):
            print(f"    KF@{i}: " + " ".join(
                f"{k}={st.get(k)}" for k in
                ("rmse", "n_active", "n_imm", "n_imm_good", "n_imm_q",
                 "n_act", "n_drop", "n_res", "e_per_res", "n_window")))
        if st["status"] == "lost":
            print(f"  LOST at {i}; recent frames:")
            for s in hist[-14:]:
                print("    " + " ".join(
                    f"{k}={s.get(k)}" for k in
                    ("frame_id", "rmse", "need_kf", "n_active", "n_imm_good",
                     "n_act", "n_drop", "e_per_res")))
            break
    dt = time.time() - t0

    ts_, poses = system.export_trajectory()
    ids = [fr.frame_id for fr in system.frames][: len(poses)]
    gt = np.stack([ds.gt_pose_c_w(i) for i in ids])
    if os.environ.get("LDSO_VIZ"):
        from ldso_tpu import viz
        viz.dump_trajectory(os.environ["LDSO_VIZ"] + f"/loop{int(loop_closing)}",
                            poses, gt)
    est_c = np.stack([-(P[:3, :3].T @ P[:3, 3]) for P in poses])
    gt_c = np.stack([-(P[:3, :3].T @ P[:3, 3]) for P in gt])
    rmse, _ = ate_rmse(est_c, gt_c, with_scale=True)
    extent = np.linalg.norm(gt_c.max(0) - gt_c.min(0))
    n_loops = len(lc.loops_closed) if lc else 0
    n_marg = sum(1 for k in system.kfs.values() if not k.in_window)
    print(f"  loop={loop_closing}: ATE {rmse:.4f} ({100*rmse/extent:.2f}% of "
          f"{extent:.2f}m) kfs={len(system.kfs)} marg={n_marg} "
          f"loops={n_loops} frames={len(poses)} [{dt:.0f}s]")
    return rmse, n_loops, system


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 240
    traj = sys.argv[2] if len(sys.argv) > 2 else "out_and_back"
    print(f"{traj} n={n}")
    r0, _, _ = run(n, False, traj=traj, verbose=True)
    r1, k, _ = run(n, True, traj=traj)
    print(f"ATE ratio with/without loops: {r1 / max(r0, 1e-9):.3f} "
          f"({k} loops)")
