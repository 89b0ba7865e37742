"""Device-facing plumbing: the compile-cache path rule, the GPU check of
the chip smoke test and the bench, the peak table of the kernel bench,
and the chip smoke test's GPU-vs-CPU comparison helper."""

import importlib.util
import json
import os

import jax
import numpy as np
import pytest

import ldso_tpu
from ldso_tpu.eval import device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestCompileCache:
    def test_defaults_to_repo_dir(self, monkeypatch):
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        monkeypatch.delenv("LDSO_NO_COMPILE_CACHE", raising=False)
        monkeypatch.setenv("JAX_PLATFORMS", "cuda")
        assert ldso_tpu.compile_cache_dir() == os.path.join(REPO, ".jax_cache")

    def test_env_dir_wins(self, monkeypatch, tmp_path):
        monkeypatch.delenv("LDSO_NO_COMPILE_CACHE", raising=False)
        monkeypatch.setenv("JAX_PLATFORMS", "cuda,cpu")
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert ldso_tpu.compile_cache_dir() == str(tmp_path)

    @pytest.mark.parametrize("env", [{"JAX_PLATFORMS": "cpu"},
                                     {"LDSO_NO_COMPILE_CACHE": "1"}])
    def test_off_for_cpu_only_or_opt_out(self, monkeypatch, env):
        monkeypatch.delenv("LDSO_NO_COMPILE_CACHE", raising=False)
        monkeypatch.setenv("JAX_PLATFORMS", "cuda")
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert ldso_tpu.compile_cache_dir() is None

    def test_setup_points_jax_at_the_dir(self, monkeypatch, tmp_path):
        monkeypatch.delenv("LDSO_NO_COMPILE_CACHE", raising=False)
        monkeypatch.setenv("JAX_PLATFORMS", "cuda")
        target = tmp_path / "cache"
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(target))
        before = (jax.config.jax_compilation_cache_dir,
                  jax.config.jax_persistent_cache_min_compile_time_secs)
        try:
            ldso_tpu._setup_compile_cache()
            assert jax.config.jax_compilation_cache_dir == str(target)
            assert target.is_dir()
        finally:
            jax.config.update("jax_compilation_cache_dir", before[0])
            jax.config.update("jax_persistent_cache_min_compile_time_secs",
                              before[1])


class TestNeedsGpu:
    def test_require_gpu_refuses_cpu(self):
        with pytest.raises(RuntimeError, match="no GPU"):
            device.require_gpu()

    def test_chip_smoke_prints_no_result_without_gpu(self, capsys):
        import chip_smoke

        with pytest.raises(RuntimeError, match="no GPU"):
            chip_smoke.main([])
        assert '"ok"' not in capsys.readouterr().out

    def test_bench_refuses_cpu(self, capsys):
        import bench

        with pytest.raises(RuntimeError, match="no GPU"):
            bench.main()
        assert capsys.readouterr().out == ""


def _bench_kernels():
    spec = importlib.util.spec_from_file_location(
        "bench_kernels", os.path.join(REPO, "scripts", "bench_kernels.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class TestPeakTable:
    def test_h100_row_from_data_sheet(self):
        name, fp32, tf32, gbps = _bench_kernels().chip_spec(
            "NVIDIA H100 80GB HBM3")
        assert (fp32, tf32, gbps) == (67.0, 495.0, 3350.0)

    @pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB",
                                      "NVIDIA H100 PCIe"])
    def test_unknown_kind_is_an_error(self, kind):
        with pytest.raises(KeyError, match="no peak rates"):
            _bench_kernels().chip_spec(kind)


def _small_drive():
    """fused_step arguments from a sync drive at preset default, 320x240."""
    from ldso_tpu.config import preset
    from ldso_tpu.io.synthetic import SyntheticDataset

    import chip_smoke

    cfg = preset("default")
    ds = SyntheticDataset(w=320, h=240, n=24, seed=0, supersample=1)
    frames = [ds.get_image(i) for i in range(ds.num_frames)]
    args = chip_smoke.capture_fused_step_args(cfg, ds, frames)
    return cfg, frames[0][0], args


def _phase_d_rows(dev, ref_dev):
    """Phase d with x64 off, as deployed, at preset default (whose
    settings the tolerances are stated for) and 320x240."""
    import __graft_entry__
    import chip_smoke

    with jax.enable_x64(False):
        cfg, img, args = _small_drive()
        return chip_smoke.compare_hot_programs(
            cfg, img, args,
            __graft_entry__.entry("default", w=320, h=240, n_frames=6),
            dev, ref_dev)


def test_compare_hot_programs_cpu_vs_cpu():
    """Phase d's helper on two CPU devices: identical programs give zero
    error, and every row states its tolerance."""
    cpu = jax.devices("cpu")
    rows = _phase_d_rows(cpu[1], cpu[0])
    assert {r["check"].split(".")[0] for r in rows} == {
        "pyramid", "fused_step", "ba_step"}
    json.dumps(rows)
    for r in rows:
        assert r["tol"] > 0 and r["err"] == 0.0, r


@pytest.mark.gpu
def test_hot_programs_match_cpu_on_gpu(gpu):
    """Phase d on a card: GPU against the CPU backend."""
    rows = _phase_d_rows(gpu, jax.devices("cpu")[0])
    bad = [r for r in rows if not r["err"] <= r["tol"]]
    assert not bad, bad


def test_system_ate_pct_matches_manual():
    """eval.ate.system_ate_pct against the inline computation it replaced."""
    from ldso_tpu.eval.ate import ate_rmse, system_ate_pct

    class _Fr:
        def __init__(self, i):
            self.frame_id = i

    rng = np.random.default_rng(0)
    gt = {i: np.eye(4) for i in range(8)}
    for i in range(8):
        gt[i][:3, 3] = [i * 0.1, 0.0, 0.02 * i * i]
    est = [P.copy() for P in gt.values()]
    for P in est:
        P[:3, 3] += 0.01 * rng.standard_normal(3)

    class _Sys:
        frames = [_Fr(i) for i in range(8)]

        def export_trajectory(self):
            return np.arange(8.0), np.stack(est)

    c = lambda P: -(P[:3, :3].T @ P[:3, 3])    # noqa: E731
    e, g = np.stack([c(P) for P in est]), np.stack([c(gt[i]) for i in range(8)])
    rmse, _ = ate_rmse(e, g)
    want = 100.0 * rmse / np.linalg.norm(g.max(0) - g.min(0))
    assert system_ate_pct(_Sys(), gt.__getitem__) == pytest.approx(want)
