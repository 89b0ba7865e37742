"""Fused per-frame device programs: track step, trace step, fused step.

JAX redesign of the reference's per-frame path
(reference: n-lalanne/LDSO src/frontend/FullSystem.cc addActiveFrame →
makeImages → trackNewCoarse, and mappingLoop → traceNewCoarse): instead
of one host call per pyramid level / per motion hypothesis / per trace,
the tracking front half is ONE jitted XLA program.

Three entry points:
  * ``track_step``   — pyramid build → device-side constant-velocity
    prediction → batched motion-hypothesis ladder → winner refinement →
    flow indicators → KF-decision score → affine transfer. The pose
    prediction is computed IN-PROGRAM from the previous two relative
    poses (device arrays), so a pipelined host can dispatch frame N+1
    before reading frame N's result — RPC latency to the device hides
    behind compute (SURVEY §7.2 risk 5).
  * ``trace_step``   — epipolar search of every immature point, bank
    updated functionally on device (zero host traffic between KFs).
  * ``fused_step``   — track + trace in a single dispatch with a single
    packed readback (synchronous mode: 1 h2d image + 1 d2h diag per
    frame).

The per-frame readback is ONE small vector ``diag`` whose layout is the
DIAG_* indices below; the winning refToNew pose rides inside it
(DIAG_T..DIAG_T+16) so no second transfer is needed.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ldso_tpu import tracker
from ldso_tpu import trace as trace_mod
from ldso_tpu.core.bank import Bank
from ldso_tpu.kernels.pyramid import build_pyramid
from ldso_tpu.math import lie

_HI = jax.lax.Precision.HIGHEST

# diag vector layout returned by track_step / fused_step
DIAG_RMSE0 = 0
DIAG_FRAC_SAT = 1
DIAG_FRAC_OOB = 2
DIAG_FLOW_T = 3
DIAG_FLOW_RT = 4
DIAG_FLOW_R = 5
DIAG_KF_DELTA = 6
DIAG_A_ABS = 7
DIAG_B_ABS = 8
DIAG_A_REL = 9
DIAG_B_REL = 10
DIAG_T = 11                      # [11:27) row-major refToNew SE3
DIAG_LEN = 27


class TrackStepOut(NamedTuple):
    pyr: tuple               # L × [H_l, W_l, 3] device pyramid of the new frame
    gsq: tuple               # L × [H_l, W_l] squared gradient magnitude
    T: jnp.ndarray           # [4, 4] refToNew SE3 (device consumer handle)
    diag: jnp.ndarray        # [DIAG_LEN] f32 — the single per-frame readback


class FusedStepOut(NamedTuple):
    pyr: tuple
    gsq: tuple
    T: jnp.ndarray
    bank: Bank               # bank after tracing against this frame
    diag: jnp.ndarray


def _track_core(img, ref, T_last, T_prelast, ab0, intr, new_exposure, cfg):
    """Shared tracking body (traced)."""
    L = cfg.shapes.pyr_levels
    # accept uint8 frames: shipping 8-bit and widening on device cuts
    # the per-frame h2d bytes 4x (dataset frames are 8-bit at the sensor)
    img = img.astype(jnp.float32)
    pyr, gsq = build_pyramid(img, L)
    # constant-velocity prediction from the previous two refToNew poses
    # (reference: lastF_2_fh_tries seed) — all on device
    vel = lie.se3_mul(T_last, lie.se3_inverse(T_prelast))
    T_cv = lie.se3_mul(vel, T_last)
    hyps = tracker.motion_hypotheses(T_cv, num=cfg.shapes.num_hypotheses)
    tr = tracker.track_frame(pyr, ref, hyps, ab0, intr, cfg)

    # keyframe-decision score (reference: FullSystem.cc KF criterion;
    # weights premultiplied by nominal 640+480)
    tc = cfg.tracker
    h, w = img.shape
    norm = 1120.0 / (w + h)
    delta = tc.kf_global_weight * norm * (
        tc.max_shift_weight_t * tr.flow[0]
        + tc.max_shift_weight_r * tr.flow[2]
        + tc.max_shift_weight_rt * tr.flow[1]
    ) + tc.max_affine_weight * jnp.abs(tr.ab[0])

    # absolute affine of the new frame from the relative track result
    # (reference: AffLight::fromToVecExposure inverted)
    alpha_rel = jnp.exp(tr.ab[0])
    e_ref = jnp.maximum(ref.exposure, 1e-6)
    a_ref, b_ref = ref.aff_ab[0], ref.aff_ab[1]
    a_abs = jnp.log(jnp.maximum(
        alpha_rel * e_ref * jnp.exp(a_ref) / jnp.maximum(new_exposure, 1e-6),
        1e-12))
    b_abs = tr.ab[1] + alpha_rel * b_ref

    diag = jnp.concatenate([
        jnp.stack([tr.rmse[0], tr.frac_saturated, tr.frac_oob,
                   tr.flow[0], tr.flow[1], tr.flow[2],
                   delta, a_abs, b_abs, tr.ab[0], tr.ab[1]]),
        tr.T.reshape(-1),
    ]).astype(jnp.float32)
    return pyr, gsq, tr.T, (a_abs, b_abs), diag


@functools.partial(jax.jit, static_argnames=("cfg",))
def track_step(img, ref: tracker.TrackerRef, T_last, T_prelast, ab0, intr,
               new_exposure, cfg) -> TrackStepOut:
    """img [H, W] f32 (pre-cropped) → fused pyramid + pyramidal track."""
    pyr, gsq, T, _, diag = _track_core(
        img, ref, T_last, T_prelast, ab0, intr, new_exposure, cfg)
    return TrackStepOut(pyr=tuple(pyr), gsq=tuple(gsq), T=T, diag=diag)


def _trace_core(img3_new, bank, T_eval, x, exposure_all, T_new_cw, ab_abs,
                exposure_new, intr, cfg) -> Bank:
    """Shared tracing body (traced) — reference: traceNewCoarse →
    ImmaturePoint::traceOn per point; here one batched program."""
    tcfg = cfg.trace
    T_all = lie.se3_mul(lie.se3_exp(x[:, :6]), T_eval)          # [F,4,4]
    T_inv = lie.se3_inverse(T_all)
    T_hn_all = jnp.einsum("ij,fjk->fik", T_new_cw, T_inv, precision=_HI)
    T_hn = T_hn_all[bank.host_slot]                              # [N,4,4]

    ea_h = exposure_all[bank.host_slot] * jnp.exp(x[bank.host_slot, 6])
    alpha = (exposure_new * jnp.exp(ab_abs[0])) / jnp.maximum(ea_h, 1e-12)
    beta = ab_abs[1] - alpha * x[bank.host_slot, 7]
    ab = jnp.stack([alpha, beta], axis=-1)

    first = jnp.isnan(bank.idepth_max)
    d_min = jnp.where(first, 0.0, bank.idepth_min)
    d_max = jnp.where(first, 1e8, bank.idepth_max)

    res = trace_mod.trace_points(
        img3_new, bank.uv, bank.color, d_min, d_max, bank.valid,
        T_hn, ab, intr,
        num_samples=cfg.shapes.epi_samples,
        gn_iters=tcfg.gn_iterations,
        max_pix_search_frac=tcfg.max_pix_search_frac,
        min_quality=tcfg.min_quality,
        step_size=tcfg.step_size,
        slack_interval=tcfg.trace_slack_interval,
        extra_slack=tcfg.extra_slack,
        gn_threshold=tcfg.gn_threshold,
        sweep_pattern=tcfg.sweep_pattern)

    st = res.status
    good = bank.valid & (st == trace_mod.GOOD)
    new_outlier = bank.outlier_count + jnp.where(
        bank.valid & (st == trace_mod.OUTLIER), 1, 0)
    # drop hopeless candidates — OOB immediately (reference:
    # activatePointsMT deletes on IPS_OOB), persistent outliers after
    # many strikes
    dropped = bank.valid & ((st == trace_mod.OOB) | (new_outlier >= 8))
    # pin output dtypes to the bank's (x64 mode can promote through
    # python-float literals; the batch scan carries the bank and needs
    # dtype-stable round trips)
    return bank._replace(
        valid=bank.valid & ~dropped,
        idepth_min=jnp.where(good, res.idepth_min, bank.idepth_min)
        .astype(bank.idepth_min.dtype),
        idepth_max=jnp.where(good, res.idepth_max, bank.idepth_max)
        .astype(bank.idepth_max.dtype),
        quality=jnp.where(bank.valid, res.quality, bank.quality)
        .astype(bank.quality.dtype),
        last_status=jnp.where(bank.valid, st, bank.last_status)
        .astype(bank.last_status.dtype),
        outlier_count=new_outlier.astype(bank.outlier_count.dtype),
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
def trace_step(img3_new, bank: Bank, T_eval, x, exposure_all,
               T_new_cw, ab_abs, exposure_new, intr, cfg) -> Bank:
    """Epipolar-trace every immature point against the new frame and
    return the updated device bank (zero host traffic)."""
    return _trace_core(img3_new, bank, T_eval, x, exposure_all, T_new_cw,
                       ab_abs, exposure_new, intr, cfg)


@functools.partial(jax.jit, static_argnames=("cfg",))
def fused_step(img, ref: tracker.TrackerRef, T_last, T_prelast, ab0,
               bank: Bank, T_eval, x, exposure_all, T_ref_cw,
               intr, new_exposure, cfg) -> FusedStepOut:
    """Track + trace in ONE dispatch (synchronous mode): the traced pose
    feeds the epipolar search without leaving the device; the host reads
    one packed diag vector per frame."""
    pyr, gsq, T, (a_abs, b_abs), diag = _track_core(
        img, ref, T_last, T_prelast, ab0, intr, new_exposure, cfg)
    T_new_cw = lie.se3_mul(T, T_ref_cw)
    new_bank = _trace_core(pyr[0], bank, T_eval, x, exposure_all, T_new_cw,
                           jnp.stack([a_abs, b_abs]), new_exposure, intr, cfg)
    return FusedStepOut(pyr=tuple(pyr), gsq=tuple(gsq), T=T, bank=new_bank,
                        diag=diag)


class FusedBatchOut(NamedTuple):
    pyr: tuple               # L × [B, H_l, W_l, 3] stacked pyramids
    diags: jnp.ndarray       # [B, DIAG_LEN] — ONE d2h per B frames
    bank: Bank               # bank after tracing all B frames
    T_last: jnp.ndarray      # [4, 4] last refToNew (device carry)
    T_prelast: jnp.ndarray   # [4, 4]
    ab_rel: jnp.ndarray      # [2] last relative affine (device carry)


@functools.partial(jax.jit, static_argnames=("cfg",))
def fused_batch(imgs, exposures, ref: tracker.TrackerRef, T_last, T_prelast,
                ab0, bank: Bank, T_eval, x, exposure_all, T_ref_cw,
                intr, cfg) -> FusedBatchOut:
    """Track + trace B frames in ONE device dispatch.

    Where every host↔device interaction has a fixed cost, the per-frame
    floor is set by dispatches per frame, not by device compute. This
    program amortizes one h2d (stacked uint8 frames), one dispatch, and
    one d2h (stacked diags) over B frames via `lax.scan`: the
    constant-velocity prediction pair, the relative-affine chain, and
    the immature bank all ride the scan carry exactly as they ride
    host state in the per-frame path (reference analog: the
    addActiveFrame → trackNewCoarse → traceNewCoarse chain runs
    per-frame with shared-memory state, FullSystem.cc:~L180).

    KF decisions read the stacked diags AFTER the batch — decision
    latency grows by ≤B-1 frames on top of the pipeline depth, the same
    trade the reference's mapping-backlog skip already makes."""

    stride = max(int(cfg.trace.trace_every), 1)

    def body(carry, inp):
        T_l, T_p, ab, bk = carry
        img, expo, it = inp
        pyr, gsq, T, (a_abs, b_abs), diag = _track_core(
            img, ref, T_l, T_p, ab, intr, expo, cfg)
        T_new_cw = lie.se3_mul(T, T_ref_cw)

        def do_trace(b):
            return _trace_core(pyr[0], b, T_eval, x, exposure_all, T_new_cw,
                               jnp.stack([a_abs, b_abs]), expo, intr, cfg)

        if stride == 1:
            bk = do_trace(bk)
        else:
            # realtime work-shedding (reference preset=1 semantics):
            # trace only every `stride`th frame of the batch
            bk = jax.lax.cond(it % stride == 0, do_trace, lambda b: b, bk)
        ab_rel = diag[DIAG_A_REL:DIAG_B_REL + 1]
        return (T, T_l, ab_rel, bk), (tuple(pyr), diag)

    (T_l, T_p, ab_rel, bank), (pyrs, diags) = jax.lax.scan(
        body, (T_last, T_prelast, ab0, bank),
        (imgs, exposures, jnp.arange(imgs.shape[0])))
    return FusedBatchOut(pyr=tuple(pyrs), diags=diags, bank=bank,
                         T_last=T_l, T_prelast=T_p, ab_rel=ab_rel)


@jax.jit
def slice_pyr(pyr_batch, idx):
    """One dispatch extracting frame ``idx``'s full pyramid from a batch
    (the KF path needs its levels as standalone arrays)."""
    return tuple(p[idx] for p in pyr_batch)
