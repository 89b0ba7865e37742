"""Bundle-adjustment correctness: Jacobians vs autodiff, Schur algebra,
marginalization algebra, and convergence to ground truth on synthetic data."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ldso_tpu import cameras
from ldso_tpu.config import preset
from ldso_tpu.core import window as W
from ldso_tpu.ba import marginal, residuals, solve
from ldso_tpu.io import synthetic
from ldso_tpu.kernels import interp, pyramid
from ldso_tpu.math import lie

CFG = preset("tiny")


# ---------------------------------------------------------------------------
# Jacobian property tests (hand-rolled factored blocks vs jax.jacfwd)
# ---------------------------------------------------------------------------


def _proj_chain(xi_t, xi_h, c, d, T_t0, T_h0, uv):
    """Exact projection chain used by the BA kernel: host pixel -> target
    pixel, as a pure function of the tangent states at FEJ."""
    T_rel = (
        lie.se3_exp(xi_t) @ T_t0 @ lie.se3_inverse(T_h0) @ lie.se3_exp(-xi_h)
    )
    fx, fy, cx, cy = c[0], c[1], c[2], c[3]
    xh = jnp.stack([(uv[0] - cx) / fx, (uv[1] - cy) / fy, 1.0])
    X = T_rel[:3, :3] @ xh + d * T_rel[:3, 3]
    return jnp.stack([fx * X[0] / X[2] + cx, fy * X[1] / X[2] + cy])


class TestProjectionJacobians:
    def setup_method(self):
        rng = np.random.default_rng(7)
        self.T_h0 = jnp.asarray(
            lie.se3_exp(jnp.asarray(rng.normal(size=6) * 0.3)), jnp.float64
        )
        self.T_t0 = jnp.asarray(
            lie.se3_exp(jnp.asarray(rng.normal(size=6) * 0.3)), jnp.float64
        )
        self.c = jnp.asarray([400.0, 410.0, 250.0, 190.0], jnp.float64)
        self.uv = jnp.asarray([300.0, 200.0], jnp.float64)
        self.d = jnp.asarray(0.7, jnp.float64)

    def _fej_quantities(self):
        T_rel = self.T_t0 @ lie.se3_inverse(self.T_h0)
        R, t = T_rel[:3, :3], T_rel[:3, 3]
        fx, fy, cx, cy = self.c
        xh = jnp.stack([(self.uv[0] - cx) / fx, (self.uv[1] - cy) / fy, 1.0])
        X = R @ xh + self.d * t
        drescale = 1.0 / X[2]
        up, vp = X[0] * drescale, X[1] * drescale
        new_id = self.d * drescale
        return T_rel, R, t, xh, drescale, up, vp, new_id

    def test_pose_jacobian_target(self):
        J_auto = jax.jacfwd(
            lambda xi: _proj_chain(xi, jnp.zeros(6, jnp.float64), self.c, self.d,
                                   self.T_t0, self.T_h0, self.uv)
        )(jnp.zeros(6, jnp.float64))
        _, R, t, xh, dre, up, vp, nid = self._fej_quantities()
        J_hand = residuals._pose_jacobian(up, vp, nid, self.c[0], self.c[1])
        np.testing.assert_allclose(J_auto, J_hand, rtol=1e-6, atol=1e-8)

    def test_pose_jacobian_host_adjoint_transport(self):
        J_auto = jax.jacfwd(
            lambda xi: _proj_chain(jnp.zeros(6, jnp.float64), xi, self.c, self.d,
                                   self.T_t0, self.T_h0, self.uv)
        )(jnp.zeros(6, jnp.float64))
        T_rel, R, t, xh, dre, up, vp, nid = self._fej_quantities()
        Jt = residuals._pose_jacobian(up, vp, nid, self.c[0], self.c[1])
        J_hand = -Jt @ lie.se3_adjoint(T_rel)
        np.testing.assert_allclose(J_auto, J_hand, rtol=1e-6, atol=1e-8)

    def test_cam_jacobian(self):
        J_auto = jax.jacfwd(
            lambda c: _proj_chain(jnp.zeros(6, jnp.float64), jnp.zeros(6, jnp.float64),
                                  c, self.d, self.T_t0, self.T_h0, self.uv)
        )(self.c)
        _, R, t, xh, dre, up, vp, nid = self._fej_quantities()
        J_hand = residuals._cam_jacobian(up, vp, dre, xh, R, self.c[0], self.c[1], self.c)
        np.testing.assert_allclose(J_auto, J_hand, rtol=1e-6, atol=1e-8)

    def test_idepth_jacobian(self):
        J_auto = jax.jacfwd(
            lambda d: _proj_chain(jnp.zeros(6, jnp.float64), jnp.zeros(6, jnp.float64),
                                  self.c, d, self.T_t0, self.T_h0, self.uv)
        )(self.d)
        _, R, t, xh, dre, up, vp, nid = self._fej_quantities()
        J_hand = jnp.stack([
            self.c[0] * dre * (t[0] - t[2] * up),
            self.c[1] * dre * (t[1] - t[2] * vp),
        ])
        np.testing.assert_allclose(J_auto, J_hand, rtol=1e-6, atol=1e-8)


# ---------------------------------------------------------------------------
# Window construction helper from synthetic ground truth
# ---------------------------------------------------------------------------


def make_synthetic_window(n_frames=3, n_points=100, seed=0, w=256, h=192,
                          idepth_noise=0.0, pose_noise=0.0, step=0.25):
    """Window of keyframe-spaced synthetic frames (step ≈ realistic KF
    baseline at scene depths of 2-5 m)."""
    ds = synthetic.SyntheticDataset(w=w, h=h, n=n_frames, seed=seed)
    ds.poses_w_c = synthetic.trajectory(n_frames, "forward_arc", step=step)
    ds._cache = {}
    cfg = CFG
    intr = ds.intrinsics()
    win = W.empty_window(cfg, h, w, intr)
    rng = np.random.default_rng(seed + 5)

    for i in range(n_frames):
        img, ts, exp = ds.get_image(i)
        pyr, _ = pyramid.build_pyramid(jnp.asarray(img), 1)
        T = ds.gt_pose_c_w(i)
        if pose_noise > 0 and i > 0:
            T = np.asarray(lie.se3_exp(jnp.asarray(rng.normal(size=6) * pose_noise)), np.float64) @ T
        win = W.insert_frame(win, i, jnp.asarray(T, jnp.float32), pyr[0], exp)

    # points in frame 0 at textured locations with GT idepth
    idep0 = ds.get_idepth(0)
    img0 = np.asarray(win.images[0][..., 0])
    gx = np.asarray(win.images[0][..., 1])
    gy = np.asarray(win.images[0][..., 2])
    gsq = gx ** 2 + gy ** 2
    ok = (idep0 > 1e-3)
    ok[: 10, :] = ok[-10:, :] = False
    ok[:, :10] = ok[:, -10:] = False
    cand = np.argwhere(ok & (gsq > np.percentile(gsq, 70)))
    sel = cand[rng.choice(len(cand), size=n_points, replace=False)]
    uv = np.stack([sel[:, 1], sel[:, 0]], axis=-1).astype(np.float32)

    pat = np.asarray(W.PATTERN_OFFSETS)
    uvp = uv[:, None, :] + pat[None]
    color = np.asarray(interp.bilinear(jnp.asarray(img0), jnp.asarray(uvp)))
    gsq_p = np.asarray(interp.bilinear(jnp.asarray(gsq.astype(np.float32)), jnp.asarray(uvp)))
    c2 = CFG.ba.outlier_th_sum_component
    weight = np.sqrt(c2 / (c2 + gsq_p)).astype(np.float32)
    idep = idep0[sel[:, 0], sel[:, 1]]
    if idepth_noise > 0:
        idep = idep * (1.0 + rng.normal(size=idep.shape) * idepth_noise)

    win = W.add_points(win, np.arange(n_points), 0, uv, color, weight, idep.astype(np.float32))
    return win, ds


class TestAssemble:
    def test_zero_residual_at_ground_truth(self):
        win, ds = make_synthetic_window()
        sys = residuals.assemble(win, huber_th=CFG.ba.huber_th,
                                 outlier_sum=CFG.ba.outlier_th_sum_component)
        n = int(sys.num_res)
        assert n > 100 * 8 * 0.8, f"too few valid residuals: {n}"
        # the tail carries occlusion-edge outliers (that's what Huber is
        # for); the BULK must be near zero at ground truth
        e_pair = np.asarray(sys.e_pair)[np.asarray(sys.valid_pair)]
        med = float(np.median(e_pair))
        assert med < 150.0, f"median pair energy at GT should be small: {med}"

    def test_gradient_points_downhill(self):
        win, ds = make_synthetic_window(idepth_noise=0.05)
        sys = residuals.assemble(win, huber_th=CFG.ba.huber_th,
                                 outlier_sum=CFG.ba.outlier_th_sum_component)
        # a damped Newton step on idepths must reduce energy
        dd = -0.2 * np.asarray(sys.b_d) / (np.asarray(sys.H_dd) + 1e-6)
        win2 = win._replace(p_idepth=win.p_idepth + jnp.asarray(dd))
        e2, _ = residuals.energy_only(win2, huber_th=CFG.ba.huber_th,
                                      outlier_sum=CFG.ba.outlier_th_sum_component)
        assert float(e2) < float(sys.energy)


class TestSchur:
    def test_schur_equals_dense_joint_solve(self):
        win, _ = make_synthetic_window(n_points=40, idepth_noise=0.05, pose_noise=0.002)
        sys = residuals.assemble(win, huber_th=CFG.ba.huber_th,
                                 outlier_sum=CFG.ba.outlier_th_sum_component)
        D = sys.H.shape[0]
        P = sys.H_dd.shape[0]
        H = np.asarray(sys.H, np.float64)
        b = np.asarray(sys.b, np.float64)
        Hxd = np.asarray(sys.H_xd, np.float64)
        Hdd = np.asarray(sys.H_dd, np.float64)
        bd = np.asarray(sys.b_d, np.float64)
        act = np.asarray(win.p_valid) & (Hdd > 1e-10)
        # regularize so both solves are well-posed
        lam_x = 1e-1 * (np.trace(H) / D) * np.eye(D)
        lam_d = 1e-3 * np.where(act, Hdd, 1.0)

        # dense joint system over active idepths
        ai = np.where(act)[0]
        nA = len(ai)
        Hj = np.zeros((D + nA, D + nA))
        Hj[:D, :D] = H + lam_x
        Hj[:D, D:] = Hxd[ai].T
        Hj[D:, :D] = Hxd[ai]
        Hj[D + np.arange(nA), D + np.arange(nA)] = Hdd[ai] + lam_d[ai]
        bj = np.concatenate([b, bd[ai]])
        x_joint = -np.linalg.solve(Hj, bj)

        # Schur path
        inv_dd = 1.0 / (Hdd[ai] + lam_d[ai])
        H_sc = Hxd[ai].T @ (Hxd[ai] * inv_dd[:, None])
        b_sc = Hxd[ai].T @ (bd[ai] * inv_dd)
        dx = -np.linalg.solve(H + lam_x - H_sc, b - b_sc)
        dd = -(bd[ai] + Hxd[ai] @ dx) * inv_dd

        np.testing.assert_allclose(dx, x_joint[:D], rtol=1e-5, atol=1e-8)
        np.testing.assert_allclose(dd, x_joint[D:], rtol=1e-5, atol=1e-8)


class TestMarginalizationAlgebra:
    def test_frame_schur_is_gaussian_marginal(self):
        rng = np.random.default_rng(3)
        D = CFG.shapes.state_dim
        A = rng.normal(size=(D, D + 10))
        HM = A @ A.T + 0.5 * np.eye(D)
        bM = rng.normal(size=D)
        slot = 1
        HM2, bM2 = marginal.marginalize_frame(slot, HM, bM)
        idx_v = np.arange(8 * slot, 8 * slot + 8)
        idx_k = np.setdiff1d(np.arange(D), idx_v)
        # brute force: Schur complement = marginal information
        Hvv_inv = np.linalg.inv(HM[np.ix_(idx_v, idx_v)])
        H_ref = HM[np.ix_(idx_k, idx_k)] - HM[np.ix_(idx_k, idx_v)] @ Hvv_inv @ HM[np.ix_(idx_v, idx_k)]
        b_ref = bM[idx_k] - HM[np.ix_(idx_k, idx_v)] @ (Hvv_inv @ bM[idx_v])
        np.testing.assert_allclose(HM2[np.ix_(idx_k, idx_k)], H_ref, rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(bM2[idx_k], b_ref, rtol=1e-6, atol=1e-7)
        # freed slot is zeroed
        assert np.abs(HM2[idx_v]).max() == 0.0


class TestBAConvergence:
    def test_recovers_idepth(self):
        win, ds = make_synthetic_window(n_points=120, idepth_noise=0.08)
        gt_idepth = np.asarray(win.p_idepth) / (
            1.0 + 0.0
        )  # noise applied inside helper; recompute GT:
        idep0 = ds.get_idepth(0)
        uv = np.asarray(win.p_uv[:120]).astype(int)
        gt = idep0[uv[:, 1], uv[:, 0]]

        D = CFG.shapes.state_dim
        HM, bM = marginal.empty_prior(D)
        win2, stats = solve.run_ba(win, HM, bM, CFG, anchor_slot=0)
        est = np.asarray(win2.p_idepth[:120])
        rel_err = np.abs(est - gt) / gt
        assert stats.energy_final < stats.energy_initial
        assert np.median(rel_err) < 0.04, f"median idepth err {np.median(rel_err):.4f}"

    def test_recovers_pose(self):
        win, ds = make_synthetic_window(n_points=150, pose_noise=0.004)
        D = CFG.shapes.state_dim
        HM, bM = marginal.empty_prior(D)
        win2, stats = solve.run_ba(win, HM, bM, CFG, anchor_slot=0)
        # compare recovered relative pose 0->2 with GT (gauge-invariant)
        T = np.asarray(win2.current_pose())
        T_02 = T[2] @ np.linalg.inv(T[0])
        T_02_gt = ds.gt_pose_c_w(2) @ np.linalg.inv(ds.gt_pose_c_w(0))
        err = np.asarray(lie.se3_log(jnp.asarray(T_02 @ np.linalg.inv(T_02_gt), jnp.float64)))
        # translation gauge: compare direction + rotation
        rot_err = np.linalg.norm(err[3:])
        assert stats.energy_final < stats.energy_initial
        assert rot_err < 2e-3, f"rotation error {rot_err}"
        t_est = T_02[:3, 3]
        t_gt = T_02_gt[:3, 3]
        cos = t_est @ t_gt / (np.linalg.norm(t_est) * np.linalg.norm(t_gt) + 1e-12)
        assert cos > 0.999, f"translation direction cos {cos}"

    def test_lambda_ladder_reject_path(self):
        """device_loop=False: the reference's energy-reject λ ladder
        (reference: FullSystem::optimize accept/reject + lambda update).
        Must still converge, never accept an energy-increasing step, and
        land close to the force-accept solution."""
        win, ds = make_synthetic_window(n_points=150, pose_noise=0.004,
                                        idepth_noise=0.05)
        D = CFG.shapes.state_dim
        HM, bM = marginal.empty_prior(D)
        win_r, st_r = solve.run_ba(win, HM, bM, CFG, anchor_slot=0,
                                   device_loop=False)
        win_a, st_a = solve.run_ba(win, HM, bM, CFG, anchor_slot=0)
        assert st_r.energy_final <= st_r.energy_initial
        assert st_r.energy_final < 1.5 * st_a.energy_final + 1e-3
        # both reach the same relative pose (gauge-invariant compare)
        Tr = np.asarray(win_r.current_pose())
        Ta = np.asarray(win_a.current_pose())
        rel_r = Tr[2] @ np.linalg.inv(Tr[0])
        rel_a = Ta[2] @ np.linalg.inv(Ta[0])
        err = np.asarray(lie.se3_log(jnp.asarray(
            rel_r @ np.linalg.inv(rel_a), jnp.float64)))
        assert np.linalg.norm(err[3:]) < 5e-3, f"rot divergence {err}"

    def test_lambda_ladder_rejects_bad_system(self):
        """With a garbage initial state the reject path must back off
        (λ grows) instead of committing divergent steps."""
        win, _ = make_synthetic_window(n_points=120, pose_noise=0.3,
                                       idepth_noise=0.4, seed=3)
        D = CFG.shapes.state_dim
        HM, bM = marginal.empty_prior(D)
        win_r, st = solve.run_ba(win, HM, bM, CFG, anchor_slot=0,
                                 device_loop=False)
        # energy must be monotone non-increasing by construction
        assert st.energy_final <= st.energy_initial + 1e-6
        assert np.isfinite(st.energy_final)

    def test_device_loop_anchor_is_traced(self):
        """The gauge anchor holds still wherever it is, and every anchor
        slot runs the same compiled program (which slot is oldest depends
        on keyframe timing in the async modes)."""
        win, _ = make_synthetic_window(n_points=150, pose_noise=0.004)
        D = CFG.shapes.state_dim
        HM, bM = marginal.empty_prior(D)
        T0 = np.asarray(win.current_pose())
        sizes = []
        for a in (0, 2):
            win2, _ = solve.run_ba(win, HM, bM, CFG, anchor_slot=a)
            sizes.append(solve._ba_loop_device._cache_size())
            T = np.asarray(win2.current_pose())
            np.testing.assert_allclose(T[a], T0[a], atol=1e-6)
            moved = [i for i in range(3) if i != a]
            assert max(np.abs(T[i] - T0[i]).max() for i in moved) > 1e-5
        assert sizes[1] == sizes[0]


if __name__ == "__main__":
    pytest.main([__file__, "-x", "-q"])
