"""Smoke test of the engine on one GPU, through its normal entry points.

    python chip_smoke.py                 # phases a-d on one card
    python chip_smoke.py --four-cards    # phase e only, on four cards

Phases, each of which must pass:
  a. CLI: ``ldso_tpu.cli run --dataset synthetic --frames 60`` in this
     process, loop closing on (the CLI default); not lost.
  b. Production shape: FullSystem, preset "default" (2048 points, 8-slot
     window, 8-pattern residuals, 5 levels) at 640x480 on 150 frames of
     the forward_arc corridor, in sync, pipelined and batched mode. As
     in bench.py, each mode runs twice on fresh engines: a warm-up pass
     that compiles every program it uses, then the checked pass. The
     checked pass stays tracked, marginalizes at least one keyframe, and
     keeps its scale-aligned ATE within 6 % of the trajectory's extent.
  c. Loop pair: ``bench.bench_loop_closure`` (320x240 out_and_back, 240
     frames) with loops off and on; at least one Sim(3) closure.
  d. Numerics: the pyramid build, one ``frame_step.fused_step`` and one
     BA Gauss-Newton step, each run on the GPU and on this process's
     CPU backend on the same inputs at production widths, compared
     within the tolerances stated in ``compare_hot_programs``.
  e. (``--four-cards`` only) the point-sharded BA step and both
     distributed pose graphs on a 1-D mesh of four cards against their
     single-card results (``__graft_entry__.dryrun_multichip``).

Earlier lines print each phase's numbers with the card's name and power
limit; the last line is ``{"ok": true, "device": {...}}``. Without a GPU
the script exits nonzero before any phase and prints no result. Any
failed check raises, so the exit code is nonzero and no result line is
printed.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import time

import numpy as np

ATE_BOUND_PCT = 6.0      # bench.py's own bound on scale-aligned ATE


class _CompileClock:
    """Seconds JAX spends in backend compilation, from its monitoring
    events (persistent-cache hits do not count)."""

    def __init__(self):
        import jax

        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            self.total += duration


def _emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def _check(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# a. CLI
# ---------------------------------------------------------------------------


def phase_cli(frames: int = 60, preset: str = "default") -> dict:
    from ldso_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["run", "--dataset", "synthetic", "--frames",
                       str(frames), "--preset", preset, "--output", ""])
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    _check(rc == 0, f"cli returned {rc}")
    _check(not summary["lost"], f"cli run lost tracking: {summary}")
    _check(summary["frames"] == frames, f"cli ran {summary['frames']} frames")
    return summary


# ---------------------------------------------------------------------------
# b. production shape, three execution modes
# ---------------------------------------------------------------------------

MODES = {
    "sync": dict(),
    "pipelined": dict(async_mapping=True, pipeline_depth=16),
    "batched": dict(async_mapping=True, pipeline_depth=4, batch_size=4),
}


def drive_mode(cfg, ds, frames, clock=None, **mode) -> dict:
    """One fresh FullSystem over ``frames``; ``clock`` (a _CompileClock)
    adds the pass's backend-compile seconds."""
    from ldso_tpu.eval.ate import system_ate_pct
    from ldso_tpu.system import FullSystem

    s = FullSystem(cfg, ds.intrinsics(), ds.w, ds.h, **mode)
    try:
        c0 = clock.total if clock is not None else 0.0
        t0 = time.perf_counter()
        for f in frames:
            if s.add_frame(*f).get("status") == "lost":
                break
        s.finish_mapping()
        wall = time.perf_counter() - t0
        return dict(
            frames=len(s.frames), fps=len(s.frames) / wall,
            lost=bool(s.is_lost), keyframes=len(s.kfs),
            marginalized_kfs=sum(not k.in_window for k in s.kfs.values()),
            kf_suppressed=s.kf_suppressed, kf_shed_events=s.kf_shed_events,
            compile_s=(clock.total - c0) if clock is not None else None,
            ate_pct=system_ate_pct(s, ds.gt_pose_c_w))
    finally:
        s.shutdown()


def phase_production(card: str, clock=None, n_frames: int = 150,
                     w: int = 640, h: int = 480, preset: str = "default"):
    """Phase b; returns the rendered (dataset, frames) for phase d."""
    import jax

    import bench
    from ldso_tpu.config import preset as make_preset

    cfg = make_preset(preset)
    ds, frames = bench._render_frames(n_frames, w=w, h=h)
    for name, mode in MODES.items():
        # the warm-up pass: compile stalls in an async mode delay its
        # keyframe decisions and change its trajectory
        warm = drive_mode(cfg, ds, frames, clock, **mode)
        _emit("b", mode=name, card=card, warmup=True, **warm)
        r = drive_mode(cfg, ds, frames, clock, **mode)
        stats = jax.devices()[0].memory_stats() or {}
        r["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
        _emit("b", mode=name, card=card, warmup=False, **r)
        _check(not r["lost"] and r["frames"] == n_frames,
               f"{name}: lost after {r['frames']} frames")
        _check(r["marginalized_kfs"] >= 1, f"{name}: no keyframe marginalized")
        _check(r["ate_pct"] <= ATE_BOUND_PCT,
               f"{name}: ATE {r['ate_pct']:.2f} % > {ATE_BOUND_PCT} %")
    return ds, frames


# ---------------------------------------------------------------------------
# c. loop pair
# ---------------------------------------------------------------------------


def phase_loop() -> dict:
    import bench

    r = bench.bench_loop_closure()
    _check(not r["loop_lost"], f"loop pair lost tracking: {r}")
    _check(r["n_loops"] >= 1, f"no Sim(3) loop closure accepted: {r}")
    return r


# ---------------------------------------------------------------------------
# d. hot programs: device under test vs CPU reference
# ---------------------------------------------------------------------------


def capture_fused_step_args(cfg, ds, frames, call_index: int = 5):
    """Arguments of the ``call_index``-th ``frame_step.fused_step`` call
    of a synchronous FullSystem drive over ``frames`` (a real tracker
    reference and immature bank, as production sees them)."""
    from ldso_tpu import frame_step
    from ldso_tpu.system import FullSystem

    orig = frame_step.fused_step
    calls = []

    def spy(*args):
        if len(calls) <= call_index:
            calls.append(args)
        return orig(*args)

    s = FullSystem(cfg, ds.intrinsics(), ds.w, ds.h)
    frame_step.fused_step = spy
    try:
        for f in frames:
            s.add_frame(*f)
            if len(calls) > call_index:
                return calls[call_index]
    finally:
        frame_step.fused_step = orig
        s.shutdown()
    raise RuntimeError(f"fused_step called {len(calls)} times, "
                       f"wanted call {call_index}")


def _run_on(device, fn, args):
    import jax

    out = fn(*jax.device_put(args, device))
    return jax.tree.map(np.asarray, jax.device_get(out))


def _max_abs(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def compare_hot_programs(cfg, img, fused_args, ba_entry, device, ref_device
                         ) -> list:
    """Run the pyramid build, one fused_step and one BA GN step on
    ``device`` and on ``ref_device`` and return rows ``{"check", "err",
    "tol"}``. Every product in these programs pins Precision.HIGHEST, so
    both sides compute in true float32; the tolerances allow for sums
    taken in another order (tree reductions and scatter-adds on a GPU,
    sequential loops on a CPU) and for what the iterative solvers make
    of that:

    - pyramid I/dx/dy, 1e-3 grey levels abs: 2x2 means of four float32
      values near 255 round at ~1.5e-5 per level, over five levels.
    - pyramid |grad|^2, 1e-4 relative to max(|ref|, 1): the same
      rounding, squared.
    - fused_step pose (refToNew SE(3) entries), 1e-4 abs: the tracker's
      LM stops on the same thresholds; a reordered sum moves the optimum
      by a few float32 ulps of its unit-scale entries.
    - fused_step photometric RMSE, 1e-3 relative.
    - fused_step traced-point status mismatches, 1 % of traced points:
      the epipolar search takes an argmin over samples, and a near tie
      may go either way.
    - fused_step traced idepth bounds, 99th-percentile relative
      difference over points GOOD on both sides, 1e-3.
    - BA energy of the input window, 1e-4 relative: ~10^5 residual
      terms summed in another order.
    - BA state after the step (pose/affine, idepth), 1e-3 abs: the
      damped camera solve amplifies reordered Hessian sums; one-ulp
      random noise on the assembled system moves the step by up to
      3.3e-4 on a CPU (preset default, 320x240).
    - BA energy after the step, 5e-3 relative: the same one-ulp noise
      moves it by up to 4.1e-4 at 320x240, and the step removes ~85 % of
      the energy, so the remainder is what the solve's amplification
      lands on; 5e-3 is under 1 % of the energy the step removes.
    """
    import jax

    from ldso_tpu import frame_step, trace as trace_mod
    from ldso_tpu.kernels.pyramid import build_pyramid

    L = cfg.shapes.pyr_levels
    rows = []

    pyr_fn = jax.jit(lambda x: build_pyramid(x, L))
    (pa, ga), (pr, gr) = (_run_on(d, pyr_fn, (img,))
                          for d in (device, ref_device))
    rows.append(dict(check="pyramid.I_dx_dy_abs", tol=1e-3,
                     err=max(_max_abs(a, r) for a, r in zip(pa, pr))))
    rows.append(dict(check="pyramid.gsq_rel", tol=1e-4, err=max(
        float(np.max(np.abs(a - r) / np.maximum(np.abs(r), 1.0)))
        for a, r in zip(ga, gr))))

    fs_cfg = fused_args[-1]
    fs_fn = lambda *a: frame_step.fused_step(*a, fs_cfg)   # noqa: E731
    oa, orf = (_run_on(d, fs_fn, fused_args[:-1])
               for d in (device, ref_device))
    rows.append(dict(check="fused_step.pose_abs", tol=1e-4,
                     err=_max_abs(oa.T, orf.T)))
    i = frame_step.DIAG_RMSE0
    rows.append(dict(check="fused_step.rmse_rel", tol=1e-3,
                     err=abs(float(oa.diag[i]) - float(orf.diag[i]))
                     / max(abs(float(orf.diag[i])), 1e-12)))
    live = orf.bank.valid | oa.bank.valid
    n_live = max(int(live.sum()), 1)
    rows.append(dict(check="fused_step.trace_status_mismatch_frac", tol=1e-2,
                     err=float(((oa.bank.last_status != orf.bank.last_status)
                                & live).sum()) / n_live))
    good = (live & (oa.bank.last_status == trace_mod.GOOD)
            & (orf.bank.last_status == trace_mod.GOOD))
    rel = [np.abs(getattr(oa.bank, k)[good] - getattr(orf.bank, k)[good])
           / np.maximum(np.abs(getattr(orf.bank, k)[good]), 1e-6)
           for k in ("idepth_min", "idepth_max")]
    rel = np.concatenate(rel)
    rows.append(dict(check="fused_step.trace_idepth_p99_rel", tol=1e-3,
                     err=float(np.percentile(rel, 99)) if rel.size else 0.0))

    ba_fn, ba_args = ba_entry
    ba_jit = jax.jit(ba_fn)
    (wa, ea), (wr, er) = (_run_on(d, ba_jit, ba_args)
                          for d in (device, ref_device))
    rows.append(dict(check="ba_step.energy_rel", tol=1e-4,
                     err=abs(float(ea) - float(er)) / abs(float(er))))
    rows.append(dict(check="ba_step.x_abs", tol=1e-3, err=_max_abs(wa.x, wr.x)))
    rows.append(dict(check="ba_step.p_idepth_abs", tol=1e-3,
                     err=_max_abs(wa.p_idepth, wr.p_idepth)))
    # energy of each side's stepped window, both evaluated on the reference
    (_, ea2), (_, er2) = (_run_on(ref_device, ba_jit, (w_,)) for w_ in (wa, wr))
    rows.append(dict(check="ba_step.energy_after_rel", tol=5e-3,
                     err=abs(float(ea2) - float(er2)) / abs(float(er2))))
    return rows


def phase_numerics(ds, frames, preset: str = "default",
                   w: int = 640, h: int = 480) -> list:
    import jax

    import __graft_entry__
    from ldso_tpu.config import preset as make_preset

    cfg = make_preset(preset)
    fused_args = capture_fused_step_args(cfg, ds, frames)
    return compare_hot_programs(
        cfg, frames[0][0], fused_args,
        __graft_entry__.entry(preset, w=w, h=h, n_frames=6),
        jax.devices()[0], jax.devices("cpu")[0])


def _report_rows(phase: str, card: str, rows: list):
    for r in rows:
        _emit(phase, card=card, precision="HIGHEST", **r,
              within=bool(r["err"] <= r["tol"]))
    bad = [r["check"] for r in rows if not r["err"] <= r["tol"]]
    _check(not bad, f"phase {phase}: over tolerance: {bad}")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only phase e, on four cards")
    args = p.parse_args(argv)

    # phase d needs the CPU backend beside the GPU in this process
    plat = os.environ.get("JAX_PLATFORMS")
    if plat and "cpu" not in plat.split(","):
        os.environ["JAX_PLATFORMS"] = plat + ",cpu"
    import jax

    from ldso_tpu.eval import device as device_mod

    dev = device_mod.require_gpu()
    jax.config.update("jax_enable_x64", False)   # the deployment regime
    card = device_mod.card_name_power()
    print(f"card: {card}", flush=True)
    clock = _CompileClock()

    if args.four_cards:
        _check(dev["count"] >= 4, f"--four-cards needs 4 GPUs, "
                                  f"found {dev['count']}")
        import __graft_entry__

        t0 = time.perf_counter()
        rows = __graft_entry__.dryrun_multichip(4)
        _report_rows("e", card, rows)
        _emit("e", wall_s=time.perf_counter() - t0, compile_s=clock.total)
    else:
        t0 = time.perf_counter()
        _emit("a", card=card, **phase_cli(), wall_s=time.perf_counter() - t0,
              compile_s=clock.total)

        t0, c0 = time.perf_counter(), clock.total
        ds, frames = phase_production(card, clock)
        _emit("b", wall_s=time.perf_counter() - t0,
              compile_s=clock.total - c0)

        t0, c0 = time.perf_counter(), clock.total
        _emit("c", card=card, **phase_loop(), wall_s=time.perf_counter() - t0,
              compile_s=clock.total - c0)

        t0, c0 = time.perf_counter(), clock.total
        _report_rows("d", card, phase_numerics(ds, frames))
        _emit("d", wall_s=time.perf_counter() - t0,
              compile_s=clock.total - c0)

    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
