"""Adversarial synthetic scenarios: the stand-in for
the real TUM/KITTI runs that this environment cannot perform (no
datasets, no network). Each scenario models a known reference failure
mode — abrupt exposure steps, gradient-starved low-texture spans, and
perceptually aliased (repeating-texture) corridors — and asserts the
engine's behavior: the tracker survives, and the loop gates never
accept an aliased match.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.slow  # full-sequence drives; fast CI = -m 'not slow'

from ldso_tpu.config import preset
from ldso_tpu.io.synthetic import SyntheticDataset
from ldso_tpu.system import FullSystem

CFG = preset("tiny")


def _drive(system, ds, n=None):
    n = n or ds.num_frames
    for i in range(n):
        img, ts, exp = ds.get_image(i)
        st = system.add_frame(img, ts, exp)
        assert st["status"] != "lost", f"lost at frame {i}: {st}"
    system.finish_mapping()


def _ate_pct(system, ds):
    from ldso_tpu.eval.ate import ate_rmse

    _, poses = system.export_trajectory()
    ids = [fr.frame_id for fr in system.frames][: len(poses)]
    gt = np.stack([ds.gt_pose_c_w(i) for i in ids])
    est_c = np.stack([-(P[:3, :3].T @ P[:3, 3]) for P in poses])
    gt_c = np.stack([-(P[:3, :3].T @ P[:3, 3]) for P in gt])
    rmse, _ = ate_rmse(est_c, gt_c, with_scale=True)
    extent = np.linalg.norm(gt_c.max(0) - gt_c.min(0))
    return 100.0 * rmse / extent


class TestExposureSteps:
    def test_abrupt_exposure_steps_tracked(self):
        """±40% exposure steps every 15 frames, exposures REPORTED (the
        photometrically calibrated case): the affine transfer chain
        (reference: AffLight::fromToVecExposure) must absorb the steps —
        no loss of tracking, bounded ATE."""
        ds = SyntheticDataset(w=320, h=240, n=60, traj_kind="forward_arc",
                              seed=0, exposure_steps=True)
        s = FullSystem(CFG, ds.intrinsics(), ds.w, ds.h)
        _drive(s, ds)
        assert s.initialized and not s.is_lost
        pct = _ate_pct(s, ds)
        assert pct < 8.0, f"ATE {pct:.2f}% of extent under exposure steps"

    def test_steps_actually_present(self):
        ds = SyntheticDataset(w=320, h=240, n=60, exposure_steps=True)
        e = np.asarray([ds.get_image(i)[2] for i in range(40)])
        assert e.max() / e.min() > 1.5       # the scenario really steps


class TestLowTexture:
    def test_low_texture_span_survives(self):
        """A low-contrast span on walls + floor for z∈[4,8] (the
        gradient-starved stretch): selection density collapses there but
        the tracker must survive through it on the remaining texture
        (reference failure mode: low-texture walls on TUM-Mono)."""
        ds = SyntheticDataset(w=320, h=240, n=70, traj_kind="forward_arc",
                              seed=0, scene_kind="low_texture")
        s = FullSystem(CFG, ds.intrinsics(), ds.w, ds.h)
        _drive(s, ds)
        assert s.initialized and not s.is_lost
        pct = _ate_pct(s, ds)
        assert pct < 12.0, f"ATE {pct:.2f}% through the low-texture span"

    def test_span_is_really_flat(self):
        from ldso_tpu.io.synthetic import make_scene

        sc = make_scene(0, "low_texture")
        wall = sc.planes[1].tex
        flat = wall[:, 220:380].std()
        rich = wall[:, :180].std()
        assert flat < 0.2 * rich, (flat, rich)


class TestAliasedCorridor:
    def test_no_false_loops_on_repeating_texture(self):
        """Out-and-back through a corridor whose walls tile ONE texture
        patch (repeating facade): every accepted loop must be a true
        revisit (camera centers within 20% of the trajectory extent);
        perceptually aliased candidates must die at the gates
        (reference: DetectLoop's consistency + Sim3 inlier gates)."""
        from ldso_tpu.loop.closing import AsyncLoopClosing

        ds = SyntheticDataset(w=320, h=240, n=110,
                              traj_kind="out_and_back", seed=0,
                              scene_kind="aliased")
        s = FullSystem(CFG, ds.intrinsics(), ds.w, ds.h)
        lc = AsyncLoopClosing(CFG, ds.intrinsics(), train_after=4)
        s.on_keyframe = lc.on_keyframe
        s.loop_closing = lc
        try:
            _drive(s, ds)
            lc.finish()
            assert s.initialized and not s.is_lost
            extent = 0.0
            gt_c = {}
            for kid, kf in s.kfs.items():
                P = np.asarray(kf.T_cw, np.float64)
                gt = ds.gt_pose_c_w(kf.frame_id)
                gt_c[kid] = -(gt[:3, :3].T @ gt[:3, 3])
            centers = np.stack(list(gt_c.values()))
            extent = np.linalg.norm(centers.max(0) - centers.min(0))
            for a, b, _S in lc.loops_closed:
                d = np.linalg.norm(gt_c[a] - gt_c[b])
                assert d < 0.2 * extent, \
                    f"FALSE loop {a}->{b}: gt distance {d:.2f} " \
                    f"({100 * d / extent:.0f}% of extent)"
        finally:
            lc.shutdown()
            s.shutdown()
