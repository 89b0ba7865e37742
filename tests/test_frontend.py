"""Frontend: coarse tracker, pixel selector, epipolar tracer, activation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ldso_tpu import select, trace, tracker
from ldso_tpu.config import preset
from ldso_tpu.core import window as W
from ldso_tpu.io import synthetic
from ldso_tpu.kernels import interp, pyramid
from ldso_tpu.math import lie

CFG = preset("tiny")
LEVELS = CFG.shapes.pyr_levels  # 4


def make_frames(n=2, w=256, h=192, step=0.12, seed=0):
    ds = synthetic.SyntheticDataset(w=w, h=h, n=n, seed=seed)
    ds.poses_w_c = synthetic.trajectory(n, "forward_arc", step=step)
    ds._cache = {}
    pyrs = []
    for i in range(n):
        img, _, _ = ds.get_image(i)
        pyr, gsq = pyramid.build_pyramid(jnp.asarray(img), LEVELS)
        pyrs.append((pyr, gsq))
    return ds, pyrs


def ref_points_from_gt(ds, pyr0, n_pts=400, seed=1):
    """Semi-dense reference point set from GT depth at textured pixels."""
    rng = np.random.default_rng(seed)
    idep = ds.get_idepth(0)
    img0 = np.asarray(pyr0[0][..., 0])
    g = np.asarray(pyr0[0][..., 1:3])
    gsq = (g ** 2).sum(-1)
    ok = idep > 1e-3
    ok[:8] = ok[-8:] = False
    ok[:, :8] = ok[:, -8:] = False
    cand = np.argwhere(ok & (gsq > np.percentile(gsq, 60)))
    sel = cand[rng.choice(len(cand), size=n_pts, replace=False)]
    uv = np.stack([sel[:, 1], sel[:, 0]], -1).astype(np.float32)
    return (jnp.asarray(uv), jnp.asarray(idep[sel[:, 0], sel[:, 1]]),
            jnp.asarray(img0[sel[:, 0], sel[:, 1]]), jnp.ones(n_pts, bool))


class TestTracker:
    def test_recovers_pose_from_const_velocity(self):
        ds, pyrs = make_frames(n=2, step=0.12)
        uv, idep, col, val = ref_points_from_gt(ds, pyrs[0][0])
        ref = tracker.make_tracker_ref(uv, idep, col, val, LEVELS)
        T_gt = jnp.asarray(ds.gt_pose_c_w(1) @ ds.poses_w_c[0], jnp.float32)

        # init from identity + hypothesis ladder around a rough guess
        T_rough = lie.se3_exp(lie.se3_log(T_gt.astype(jnp.float64)).astype(jnp.float32) * 0.7)
        hyps = tracker.motion_hypotheses(T_rough, CFG.shapes.num_hypotheses)
        res = tracker.track_frame(pyrs[1][0], ref, hyps, jnp.zeros(2),
                                  jnp.asarray(ds.intrinsics()), CFG)
        err = lie.se3_log((res.T @ jnp.linalg.inv(T_gt)).astype(jnp.float64))
        t_err = float(jnp.linalg.norm(err[:3]))
        r_err = float(jnp.linalg.norm(err[3:]))
        assert r_err < 2e-3, f"rotation error {r_err}"
        assert t_err < 8e-3, f"translation error {t_err}"
        assert float(res.rmse[0]) < 12.0, f"final rmse {float(res.rmse[0])}"

    def test_flow_indicators_scale_with_motion(self):
        ds, pyrs = make_frames(n=2, step=0.12)
        uv, idep, col, val = ref_points_from_gt(ds, pyrs[0][0])
        ref = tracker.make_tracker_ref(uv, idep, col, val, LEVELS)
        T_small = lie.se3_exp(jnp.asarray([0.01, 0, 0, 0, 0, 0], jnp.float32))
        T_big = lie.se3_exp(jnp.asarray([0.2, 0, 0, 0, 0, 0], jnp.float32))
        f_small = tracker._flow_indicators(ref, T_small, jnp.asarray(ds.intrinsics()))
        f_big = tracker._flow_indicators(ref, T_big, jnp.asarray(ds.intrinsics()))
        assert float(f_big[1]) > 5 * float(f_small[1])

    def test_lost_on_garbage(self):
        """Totally wrong init far outside the basin -> high rmse (isLost signal)."""
        ds, pyrs = make_frames(n=2, step=0.12)
        uv, idep, col, val = ref_points_from_gt(ds, pyrs[0][0])
        ref = tracker.make_tracker_ref(uv, idep, col, val, LEVELS)
        T_bad = lie.se3_exp(jnp.asarray([2.0, 1.5, -1.0, 0.8, 0.8, 0.8], jnp.float32))
        res = tracker.track_level(
            pyrs[1][0][0], ref.uv[0], ref.idepth[0], ref.color[0], ref.valid[0],
            T_bad, jnp.zeros(2), jnp.asarray(ds.intrinsics()),
            256, 192, 5, 20.0, 9.0)
        # either almost nothing in view or huge residual
        assert int(res[3]) < 100 or float(res[2]) > 15.0


class TestSelector:
    def test_density_and_spread(self):
        ds, pyrs = make_frames(n=1)
        pyr, gsq = pyrs[0]
        uv, scores, valid = select.select_pixels(
            pyr[0], gsq[1], gsq[2], num_want=256, block=32, pot=5)
        n = int(valid.sum())
        assert n > 150, f"selected only {n}"
        uv_np = np.asarray(uv)[np.asarray(valid)]
        # spatial spread: selected points should cover most of the image quadrants
        qx = (uv_np[:, 0] > 128).astype(int) * 2 + (uv_np[:, 1] > 96).astype(int)
        counts = np.bincount(qx, minlength=4)
        assert (counts > 10).all(), f"bad spread {counts}"

    def test_picks_high_gradient(self):
        ds, pyrs = make_frames(n=1)
        pyr, gsq = pyrs[0]
        uv, scores, valid = select.select_pixels(
            pyr[0], gsq[1], gsq[2], num_want=256)
        uv_np = np.asarray(uv)[np.asarray(valid)].astype(int)
        gsq0 = np.asarray(jnp.sum(pyr[0][..., 1:3] ** 2, -1))
        sel_g = gsq0[uv_np[:, 1], uv_np[:, 0]]
        assert np.median(sel_g) > np.median(gsq0), "selection not gradient-biased"

    def test_deterministic(self):
        ds, pyrs = make_frames(n=1)
        pyr, gsq = pyrs[0]
        a = select.select_pixels(pyr[0], gsq[1], gsq[2], num_want=128)
        b = select.select_pixels(pyr[0], gsq[1], gsq[2], num_want=128)
        np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))

    @pytest.mark.parametrize("seed", [0, 3, 7, 2**31 - 1])
    def test_hash_dirs_match_host_formula(self, seed):
        # the traced-seed dither equals the all-int64 host hash, bit for bit
        h, w, cell = 480, 640, 5
        iy = np.arange(h // cell + 1)[:, None]
        ix = np.arange(w // cell + 1)[None, :]
        a = (iy * 73856093 ^ ix * 19349663 ^ (seed * 83492791)) & 0xFFFF
        ang = a.astype(np.float64) / 65536.0 * 2 * np.pi
        ref = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
        got = jax.jit(lambda s: select._hash_dirs(h, w, cell, s))(seed)
        np.testing.assert_array_equal(np.asarray(got), ref)

    def test_one_program_for_every_seed(self):
        # a keyframe's dither seed must not pick a new compiled program:
        # a compile inside an async keyframe build stalls mapping
        ds, pyrs = make_frames(n=1)
        pyr, gsq = pyrs[0]
        outs = []
        for seed in (11, 12, 13):
            outs.append(select.select_pixels(pyr[0], gsq[1], gsq[2],
                                             num_want=96, seed=seed))
            if seed == 11:
                n0 = select.select_pixels._cache_size()
        assert select.select_pixels._cache_size() == n0
        assert not np.array_equal(np.asarray(outs[0][0]),
                                  np.asarray(outs[1][0]))


class TestTrace:
    def _setup(self, step=0.15, n_pts=300):
        ds, pyrs = make_frames(n=2, step=step, seed=3)
        uv, idep_gt, col0, val = ref_points_from_gt(ds, pyrs[0][0], n_pts=n_pts, seed=4)
        pat = jnp.asarray(W.PATTERN_OFFSETS)
        colors = interp.bilinear(pyrs[0][0][0][..., 0], uv[:, None, :] + pat[None])
        T_hn = jnp.asarray(ds.gt_pose_c_w(1) @ ds.poses_w_c[0], jnp.float32)
        return ds, pyrs, uv, idep_gt, colors, val, T_hn

    def test_interval_shrinks_and_contains_gt(self):
        ds, pyrs, uv, idep_gt, colors, val, T_hn = self._setup()
        n = uv.shape[0]
        dmin = jnp.full((n,), 0.05, jnp.float32)
        dmax = jnp.full((n,), 3.0, jnp.float32)
        res = trace.trace_points(
            pyrs[1][0][0], uv, colors, dmin, dmax, val, T_hn,
            jnp.asarray([1.0, 0.0]), jnp.asarray(ds.intrinsics()),
            num_samples=CFG.shapes.epi_samples)
        good = np.asarray(res.status) == trace.GOOD
        assert good.mean() > 0.4, f"too few GOOD traces: {good.mean()}"
        gmin = np.asarray(res.idepth_min)[good]
        gmax = np.asarray(res.idepth_max)[good]
        gt = np.asarray(idep_gt)[good]
        width = gmax - gmin
        assert np.median(width) < 0.25, f"interval did not shrink: {np.median(width)}"
        contained = (gt > gmin - 0.08) & (gt < gmax + 0.08)
        assert contained.mean() > 0.75, f"GT not contained: {contained.mean()}"

    def test_pure_rotation_skips(self):
        """No translation -> epipolar segment degenerate -> SKIPPED."""
        ds, pyrs, uv, idep_gt, colors, val, T_hn = self._setup()
        T_rot = lie.se3_exp(jnp.asarray([0, 0, 0, 0.0, 0.02, 0.0], jnp.float32))
        res = trace.trace_points(
            pyrs[1][0][0], uv, colors,
            jnp.full((uv.shape[0],), 0.05, jnp.float32),
            jnp.full((uv.shape[0],), 3.0, jnp.float32),
            val, T_rot, jnp.asarray([1.0, 0.0]), jnp.asarray(ds.intrinsics()))
        st = np.asarray(res.status)
        assert (st == trace.SKIPPED).mean() > 0.8, f"statuses: {np.bincount(st, minlength=6)}"


class TestActivation:
    def test_optimize_idepth_recovers_gt(self):
        ds, pyrs = make_frames(n=3, step=0.15, seed=5)
        uv, idep_gt, col0, val = ref_points_from_gt(ds, pyrs[0][0], n_pts=200, seed=6)
        pat = jnp.asarray(W.PATTERN_OFFSETS)
        colors = interp.bilinear(pyrs[0][0][0][..., 0], uv[:, None, :] + pat[None])
        F = 3
        imgs = jnp.stack([pyrs[i][0][0] for i in range(F)])
        T_rel = jnp.stack([
            jnp.asarray(ds.gt_pose_c_w(i) @ ds.poses_w_c[0], jnp.float32) for i in range(F)
        ])
        d0 = idep_gt * (1.0 + 0.3 * jnp.asarray(np.random.default_rng(7).normal(size=idep_gt.shape)))
        d0 = jnp.clip(d0, 0.02, 5.0)
        d, Hd, E, cnt = trace.optimize_idepth(
            imgs, jnp.ones(F, bool), T_rel, jnp.ones(F), jnp.zeros(F),
            uv, colors, d0.astype(jnp.float32), val,
            jnp.asarray(ds.intrinsics()), 0, iters=5)
        ok = (np.asarray(Hd) > 50.0) & (np.asarray(cnt) > 8)
        rel = np.abs(np.asarray(d) - np.asarray(idep_gt)) / np.asarray(idep_gt)
        assert ok.mean() > 0.5
        assert np.median(rel[ok]) < 0.08, f"median rel err {np.median(rel[ok])}"


if __name__ == "__main__":
    pytest.main([__file__, "-x", "-q"])


def _numpy_pyramid(img, levels):
    """Independent reference: 2x2 block mean for each coarser level,
    central differences with the border pixel repeated."""
    pyr, gsq = [], []
    cur = img.astype(np.float64)
    for l in range(levels):
        p = np.pad(cur, 1, mode="edge")
        dx = 0.5 * (p[1:-1, 2:] - p[1:-1, :-2])
        dy = 0.5 * (p[2:, 1:-1] - p[:-2, 1:-1])
        pyr.append(np.stack([cur, dx, dy], axis=-1))
        gsq.append(dx * dx + dy * dy)
        if l + 1 < levels:
            cur = 0.25 * (cur[0::2, 0::2] + cur[1::2, 0::2]
                          + cur[0::2, 1::2] + cur[1::2, 1::2])
    return pyr, gsq


class TestPyramidReference:
    """The pyramid build against a plain numpy reference at the
    production shape (640x480, 5 levels)."""

    @pytest.mark.parametrize("dtype", [np.uint8, np.float32])
    def test_matches_numpy_at_640x480(self, dtype):
        rng = np.random.default_rng(7)
        img = (rng.random((480, 640)) * 255.0).astype(dtype)
        pyr, gsq = jax.jit(lambda x: pyramid.build_pyramid(x, 5))(img)
        pyr_r, gsq_r = _numpy_pyramid(img, 5)
        assert [p.shape for p in pyr] == [(480 >> l, 640 >> l, 3)
                                          for l in range(5)]
        for l in range(5):
            # f32 against f64: sums of four values near 255 round at ~3e-5
            np.testing.assert_allclose(np.asarray(pyr[l]), pyr_r[l],
                                       rtol=1e-6, atol=1e-4)
            np.testing.assert_allclose(np.asarray(gsq[l]), gsq_r[l],
                                       rtol=1e-5, atol=1e-2)
