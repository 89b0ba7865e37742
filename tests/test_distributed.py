"""Distributed BA on the virtual 8-device CPU mesh (SURVEY.md §5.8):
the point-sharded single-psum GN step must agree with the single-device
solver and actually place shards across devices."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ldso_tpu.ba import solve
from ldso_tpu.ba.residuals import assemble
from ldso_tpu.config import preset
from ldso_tpu.core.window import state_delta
from ldso_tpu.distributed import sharded_ba
from ldso_tpu.eval.toys import make_synthetic_window

CFG = preset("tiny")


@pytest.fixture(scope="module")
def toy():
    win, ds = make_synthetic_window(CFG, w=128, h=96, n_frames=3,
                                    idepth_noise=0.05, pose_noise=0.003)
    return win, ds


class TestShardedBA:
    def test_matches_single_device_step(self, toy):
        win, _ = toy
        n_dev = len(jax.devices())
        assert n_dev >= 8, "conftest should provide 8 virtual devices"
        mesh = sharded_ba.make_mesh(8)
        D = CFG.shapes.state_dim
        HM = np.zeros((D, D), np.float32)
        bM = np.zeros(D, np.float32)

        # single-device reference step (same lambda, same priors)
        prior_d = jnp.asarray(solve.prior_diag(np.asarray(win.frame_valid), CFG))
        s_vec = jnp.asarray(solve.scale_vector(CFG.shapes.max_frames, CFG.scales))
        fixed = jnp.asarray(solve.fix_mask(CFG.shapes.max_frames, 0))
        sys = assemble(win, huber_th=CFG.ba.huber_th,
                       outlier_sum=CFG.ba.outlier_th_sum_component)
        dx_ref, dd_ref = solve._solve_core(
            sys.H, sys.b, sys.H_xd, sys.H_dd, sys.b_d,
            jnp.asarray(HM), jnp.asarray(bM), state_delta(win), prior_d,
            s_vec, fixed, jnp.zeros(D, jnp.float32), jnp.float32(1e-5),
            win.p_valid)
        win_ref = solve.apply_step(win, dx_ref, dd_ref)

        win_sh = sharded_ba.shard_window(win, mesh)
        step = sharded_ba.make_distributed_ba_step(mesh, CFG)
        win_out, E = step(win_sh, HM, bM, lam=1e-5)

        # f32 psum reduction order differs from the single big matmul;
        # the solve amplifies that to ~1e-3 on an ill-conditioned camera
        # system — compare at that scale, and require matching energy
        # behavior rather than bitwise steps
        np.testing.assert_allclose(np.asarray(win_out.x),
                                   np.asarray(win_ref.x), atol=3e-3)
        np.testing.assert_allclose(np.asarray(win_out.p_idepth),
                                   np.asarray(win_ref.p_idepth), atol=5e-3)
        assert np.isfinite(float(E))
        e_ref = assemble(win_ref, huber_th=CFG.ba.huber_th,
                         outlier_sum=CFG.ba.outlier_th_sum_component).energy
        win_out_local = jax.tree.map(np.asarray, win_out)
        win_out_local = type(win_out)(*[jnp.asarray(a) for a in win_out_local])
        e_out = assemble(win_out_local, huber_th=CFG.ba.huber_th,
                         outlier_sum=CFG.ba.outlier_th_sum_component).energy
        assert abs(float(e_out) - float(e_ref)) < 0.02 * float(e_ref)

    def test_energy_decreases(self, toy):
        win, _ = toy
        mesh = sharded_ba.make_mesh(8)
        D = CFG.shapes.state_dim
        HM = np.zeros((D, D), np.float32)
        bM = np.zeros(D, np.float32)
        win_sh = sharded_ba.shard_window(win, mesh)
        step = sharded_ba.make_distributed_ba_step(mesh, CFG)
        w1, E1 = step(win_sh, HM, bM)
        w2, E2 = step(w1, HM, bM)
        w3, E3 = step(w2, HM, bM)
        assert float(E3) < float(E1)

    def test_sharding_actually_distributes(self, toy):
        win, _ = toy
        mesh = sharded_ba.make_mesh(8)
        win_sh = sharded_ba.shard_window(win, mesh)
        sh = win_sh.p_idepth.sharding
        assert len(sh.device_set) == 8


class TestShardedPGO:
    def _toy_graph(self, K=24, seed=0):
        from ldso_tpu.math import lie
        rng = np.random.default_rng(seed)
        gt = []
        for i in range(K):
            th = 2 * np.pi * i / K
            Twc = np.eye(4)
            Twc[:3, :3] = np.asarray(lie.so3_exp(jnp.asarray([0.0, th, 0.0])))
            Twc[:3, 3] = [2 * np.sin(th), 0.0, 2 * (1 - np.cos(th))]
            gt.append(np.linalg.inv(Twc))
        gt = np.stack(gt)
        S = [gt[0]]
        for i in range(1, K):
            inc = gt[i] @ np.linalg.inv(gt[i - 1])
            noise = np.asarray(lie.sim3_exp(jnp.asarray(
                np.concatenate([rng.normal(0, 0.02, 6),
                                [rng.normal(0, 0.01)]]))))
            S.append(noise @ inc @ S[-1])
        S = np.stack(S)
        edges = [(i, i - 1, gt[i] @ np.linalg.inv(gt[i - 1]))
                 for i in range(1, K)]
        edges.append((K - 1, 0, gt[K - 1] @ np.linalg.inv(gt[0])))
        ei = np.asarray([e[0] for e in edges], np.int32)
        ej = np.asarray([e[1] for e in edges], np.int32)
        S_meas = np.stack([e[2] for e in edges])
        w = np.ones(len(edges))
        fixed = np.zeros(K, bool)
        fixed[0] = True
        return gt, S, ei, ej, S_meas, w, fixed

    def test_matches_single_device(self):
        from ldso_tpu.distributed import sharded_pgo
        from ldso_tpu.loop import posegraph

        gt, S, ei, ej, S_meas, w, fixed = self._toy_graph()
        ref = posegraph.optimize_pose_graph(
            jnp.asarray(S), jnp.asarray(ei), jnp.asarray(ej),
            jnp.asarray(S_meas), jnp.asarray(w), jnp.asarray(fixed),
            lm_iters=12, cg_iters=80)

        mesh = sharded_pgo.make_mesh(8)
        eis, ejs, Ss, ws = sharded_pgo.shard_edges(ei, ej, S_meas, w, mesh)
        run = sharded_pgo.make_distributed_pgo(mesh, lm_iters=12, cg_iters=80)
        out = run(jnp.asarray(S), eis, ejs, Ss, ws, jnp.asarray(fixed))

        assert len(eis.sharding.device_set) == 8
        # same optimum up to f32/psum reduction-order noise
        np.testing.assert_allclose(float(out.energy), float(ref.energy),
                                   rtol=0.05, atol=1e-8)
        np.testing.assert_allclose(np.asarray(out.S), np.asarray(ref.S),
                                   atol=2e-3)

    def test_energy_decreases_and_recovers_circle(self):
        from ldso_tpu.distributed import sharded_pgo
        from ldso_tpu.loop.posegraph import edge_residual
        from ldso_tpu.math import lie

        gt, S, ei, ej, S_meas, w, fixed = self._toy_graph(seed=3)
        mesh = sharded_pgo.make_mesh(8)
        eis, ejs, Ss, ws = sharded_pgo.shard_edges(ei, ej, S_meas, w, mesh)
        run = sharded_pgo.make_distributed_pgo(mesh, lm_iters=15, cg_iters=80)
        out = run(jnp.asarray(S), eis, ejs, Ss, ws, jnp.asarray(fixed))
        S_opt = np.asarray(out.S)

        def cam_centers(Ss, descale):
            out = []
            for Pm in Ss:
                s = np.linalg.norm(Pm[0, :3]) if descale else 1.0
                out.append(-(Pm[:3, :3].T / s) @ Pm[:3, 3])
            return np.stack(out)

        err0 = np.linalg.norm(cam_centers(S, True) - cam_centers(gt, False),
                              axis=1).mean()
        err1 = np.linalg.norm(cam_centers(S_opt, True) - cam_centers(gt, False),
                              axis=1).mean()
        assert err1 < 0.05 and err1 < 0.2 * err0


class TestBlockPGO:
    """Block-row-partitioned PGO with halo exchange (SURVEY §5.7): per-CG-
    iteration collective bytes proportional to the cross-block halo, not K.
    Equivalence vs the single-device solver at K=4096 on the virtual
    8-device mesh."""

    def _big_graph(self, K=4096, n_loops=40, seed=0):
        from ldso_tpu.math import lie
        rng = np.random.default_rng(seed)
        # ground truth: smooth 3D curve; odometry chain + random loops
        t = np.linspace(0, 4 * np.pi, K)
        gt = []
        for i in range(K):
            Twc = np.eye(4)
            Twc[:3, :3] = np.asarray(lie.so3_exp(jnp.asarray(
                [0.0, 0.3 * np.sin(t[i]), 0.0])))
            Twc[:3, 3] = [np.sin(t[i]) * 5, 0.1 * t[i], t[i]]
            gt.append(np.linalg.inv(Twc))
        gt = np.stack(gt).astype(np.float32)
        S = [gt[0]]
        for i in range(1, K):
            inc = gt[i] @ np.linalg.inv(gt[i - 1])
            noise = np.asarray(lie.sim3_exp(jnp.asarray(
                np.concatenate([rng.normal(0, 0.002, 6),
                                [rng.normal(0, 0.001)]]), jnp.float32)))
            S.append(noise @ inc @ S[-1])
        S = np.stack(S).astype(np.float32)
        edges = [(i, i - 1, gt[i] @ np.linalg.inv(gt[i - 1]))
                 for i in range(1, K)]
        for _ in range(n_loops):
            a = int(rng.integers(K // 4, K))
            b = int(rng.integers(0, a - K // 8))
            edges.append((a, b, gt[a] @ np.linalg.inv(gt[b])))
        ei = np.asarray([e[0] for e in edges], np.int32)
        ej = np.asarray([e[1] for e in edges], np.int32)
        S_meas = np.stack([e[2] for e in edges]).astype(np.float32)
        w = np.ones(len(edges), np.float32)
        fixed = np.zeros(K, bool)
        fixed[0] = True
        return gt, S, ei, ej, S_meas, w, fixed

    def test_matches_single_device_at_4096(self):
        from ldso_tpu.distributed import sharded_pgo
        from ldso_tpu.loop import posegraph

        K = 4096
        gt, S, ei, ej, S_meas, w, fixed = self._big_graph(K)
        ref = posegraph.optimize_pose_graph(
            jnp.asarray(S), jnp.asarray(ei), jnp.asarray(ej),
            jnp.asarray(S_meas), jnp.asarray(w), jnp.asarray(fixed),
            lm_iters=6, cg_iters=40)

        mesh = sharded_pgo.make_mesh(8)
        part = sharded_pgo.partition_pose_graph(K, ei, ej, S_meas, w, 8)
        # the halo is the loop structure, not the map: H ≪ B
        assert part["H"] < part["B"] // 4, (part["H"], part["B"])
        run = sharded_pgo.make_block_pgo(mesh, part, lm_iters=6,
                                         cg_iters=40)
        with mesh:
            out = run(jnp.asarray(S), jnp.asarray(fixed))
        # over 6 LM × 40 CG f32 iterations at K=4096 the two solvers'
        # accept decisions can diverge on reduction-order noise, so the
        # criterion is convergence QUALITY: the block solver must reach
        # at least the single-device energy (within noise) and both must
        # recover the ground-truth trajectory to the same accuracy
        assert float(out.energy) < 1.25 * float(ref.energy) + 1e-6, \
            (float(out.energy), float(ref.energy))

        def centers(Ss):
            R = Ss[:, :3, :3]
            sc = np.linalg.norm(R[:, 0, :], axis=-1)[:, None, None]
            return -np.einsum("kji,kj->ki", R / sc, Ss[:, :3, 3] / sc[:, :, 0])

        gt_c = centers(gt)
        err_ref = np.linalg.norm(centers(np.asarray(ref.S)) - gt_c,
                                 axis=1).mean()
        err_blk = np.linalg.norm(centers(np.asarray(out.S)) - gt_c,
                                 axis=1).mean()
        # parity with the single-device solver is the claim (at this CG
        # budget information propagates ~1 preconditioned hop/iteration,
        # so NO solver globally relaxes a 4096-chain — full relaxation
        # is covered by the small-K circle test above)
        assert err_blk < 1.05 * err_ref + 1e-3, (err_blk, err_ref)

    def test_partition_halo_encoding(self):
        """Partition invariants: every live edge lands in its i-owner's
        block with a LOCAL i index; remote j endpoints resolve through
        the exporting owner's halo table."""
        from ldso_tpu.distributed import sharded_pgo

        K, n = 64, 4
        rng = np.random.default_rng(1)
        ei = np.concatenate([np.arange(1, K),
                             rng.integers(K // 2, K, 6)]).astype(np.int32)
        ej = np.concatenate([np.arange(0, K - 1),
                             rng.integers(0, K // 4, 6)]).astype(np.int32)
        S_meas = np.tile(np.eye(4, dtype=np.float32), (len(ei), 1, 1))
        w = np.ones(len(ei), np.float32)
        part = sharded_pgo.partition_pose_graph(K, ei, ej, S_meas, w, n)
        B, H = part["B"], part["H"]
        assert (part["ei"] < B).all() and (part["ei"] >= 0).all()
        # reconstruct each remote j from the halo tables and verify
        for d in range(n):
            for p in range(part["ei"].shape[1]):
                if part["w"][d, p] <= 0:
                    continue
                enc = part["ej"][d, p]
                gi = part["ei"][d, p] + d * B
                if enc < B:
                    gj = enc + d * B
                else:
                    o, pos = divmod(enc - B, H)
                    assert part["halo_mask"][o, pos]
                    gj = part["halo_out"][o, pos] + o * B
                # the (gi, gj) pair must be one of the input edges
                hit = ((ei == gi) & (ej == gj)).any()
                assert hit, (gi, gj)


class TestGraftEntry:
    def test_entry_compiles_and_runs(self):
        import sys as _s, os
        _s.path.insert(0, os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        import __graft_entry__ as g

        fn, args = g.entry()
        out = jax.jit(fn)(*args)
        jax.block_until_ready(out)
        assert np.isfinite(float(out[1]))

    def test_dryrun_multichip(self):
        """Four devices on a flat 1-D mesh: the sharded BA step and both
        distributed pose graphs match their unsharded results."""
        import __graft_entry__ as g

        rows = g.dryrun_multichip(4)
        assert {r["check"].split(".")[0] for r in rows} == {
            "ba_step", "pgo_edge_sharded", "pgo_block"}
        bad = [r for r in rows if not r["err"] <= r["tol"]]
        assert not bad, bad


class TestMultiHostMesh:
    """2-D (processes × local devices) mesh of multi-process
    ``jax.distributed`` runs (CI shape: 2 virtual processes × 4
    devices)."""

    def test_2d_mesh_matches_1d(self, toy):
        from ldso_tpu.distributed import mesh as mesh_mod

        win, _ = toy
        D = CFG.shapes.state_dim
        HM = np.zeros((D, D), np.float32)
        bM = np.zeros(D, np.float32)

        mesh1 = sharded_ba.make_mesh(8)
        win1 = sharded_ba.shard_window(win, mesh1)
        step1 = sharded_ba.make_distributed_ba_step(mesh1, CFG)
        out1, E1 = step1(win1, HM, bM, lam=1e-5)

        mesh2 = mesh_mod.make_mesh_2d(n_hosts=2)
        assert mesh2.axis_names == ("proc", "local")
        win2 = sharded_ba.shard_window(win, mesh2)
        step2 = sharded_ba.make_distributed_ba_step(mesh2, CFG)
        out2, E2 = step2(win2, HM, bM, lam=1e-5)

        np.testing.assert_allclose(np.asarray(out1.x), np.asarray(out2.x),
                                   atol=2e-3)
        np.testing.assert_allclose(np.asarray(out1.p_idepth),
                                   np.asarray(out2.p_idepth), atol=5e-3)
        assert np.isfinite(float(E2))

    def test_init_distributed_noop_without_coordinator(self, monkeypatch):
        from ldso_tpu.distributed import mesh as mesh_mod

        monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
        assert mesh_mod.init_distributed() is False

    def test_mesh_shapes(self):
        from ldso_tpu.distributed import mesh as mesh_mod

        m = mesh_mod.make_mesh_2d(n_hosts=4)
        assert m.devices.shape == (4, 2)
        with np.testing.assert_raises(ValueError):
            mesh_mod.make_mesh_2d(n_hosts=3)
