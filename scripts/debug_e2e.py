"""Debug driver: run the full system on a synthetic sequence, print ATE."""
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_compilation_cache_dir", "/tmp/jaxcache")
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.2)

import numpy as np
import time

from ldso_tpu.config import preset
from ldso_tpu.io.synthetic import SyntheticDataset
from ldso_tpu.system import FullSystem
from ldso_tpu.eval.ate import ate_rmse

def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 40
    ds = SyntheticDataset(w=320, h=240, n=n, traj_kind="forward_arc", seed=0)
    cfg = preset("tiny")
    sysm = FullSystem(cfg, ds.intrinsics(), ds.w, ds.h)
    t0 = time.time()
    for i in range(ds.num_frames):
        img, ts, exp = ds.get_image(i)
        st = sysm.add_frame(img, ts, exp)
        keys = {k: v for k, v in st.items() if k in
                ("status", "rmse", "need_kf", "kf_id", "ba_energy", "n_active",
                 "n_good", "snapped", "t_norm", "n_act", "n_drop", "e_per_res",
                 "n_res", "n_window", "n_imm", "n_imm_good", "n_imm_q")}
        print(f"[{i:3d}] {keys}")
        if st["status"] == "lost":
            break
    dt = time.time() - t0
    print(f"wall: {dt:.1f}s ({dt/ds.num_frames*1000:.0f} ms/frame)")

    ts_arr, poses = sysm.export_trajectory()
    ids = [fr.frame_id for fr in sysm.frames]
    gt = np.stack([ds.gt_pose_c_w(i) for i in ids[: len(poses)]])
    # est camera centers vs gt camera centers
    est_c = np.stack([-(P[:3, :3].T @ P[:3, 3]) for P in poses])
    gt_c = np.stack([-(P[:3, :3].T @ P[:3, 3]) for P in gt])
    rmse, _ = ate_rmse(est_c, gt_c, with_scale=True)
    extent = np.linalg.norm(gt_c.max(0) - gt_c.min(0))
    print(f"frames tracked: {len(poses)}  ATE (scale-aligned): {rmse:.4f} m "
          f"({100*rmse/extent:.2f}% of extent {extent:.2f} m)")

if __name__ == "__main__":
    main()
