"""Frame-to-keyframe direct image alignment (the coarse tracker).

JAX redesign of the reference's ``CoarseTracker``
(reference: n-lalanne/LDSO src/frontend/CoarseTracker.cc): pyramidal
Gauss-Newton on the 8-dof relative state [xi(6), a, b] against a
semi-dense reference point set, with the reference's residual cutoff
(``setting_coarseCutoffTH``) and Huber weighting.

Deliberate differences from the reference:
  * the reference tries up to 27 motion hypotheses SEQUENTIALLY with
    early exit (trackNewestCoarse); here all hypotheses run BATCHED
    (vmap) through the coarse levels in parallel — more work, same
    wall-clock on the device — and only the winner refines through the
    fine levels (SURVEY.md §2.1 row 29).
  * per-level reference data is a fixed-capacity point list (uv, idepth,
    color) instead of dilated semi-dense maps; dilation is emulated by
    including each point once per level at scaled coordinates.

GN iterations run on device inside ``lax.fori_loop``; one host readback
per track (final pose + diagnostics).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ldso_tpu.cameras import level_intrinsics
from ldso_tpu.kernels.interp import (bilinear33, bilinear_packed, in_bounds,
                                     pack_corners)
from ldso_tpu.math import lie

_HI = jax.lax.Precision.HIGHEST


class TrackerRef(NamedTuple):
    """Reference keyframe data for tracking (per pyramid level).

    Built once per keyframe (reference: CoarseTracker::setCoarseTrackingRef
    + makeCoarseDepthL0)."""

    uv: Tuple[jnp.ndarray, ...]       # per level [N_l, 2] pixel coords (level scale)
    idepth: Tuple[jnp.ndarray, ...]   # per level [N_l]
    color: Tuple[jnp.ndarray, ...]    # per level [N_l]
    valid: Tuple[jnp.ndarray, ...]    # per level [N_l] bool
    exposure: jnp.ndarray             # scalar
    aff_ab: jnp.ndarray               # [2] reference frame's affine state


class TrackResult(NamedTuple):
    T: jnp.ndarray            # [4, 4] refToNew SE3
    ab: jnp.ndarray           # [2] affine (a, b) of new frame relative to ref
    rmse: jnp.ndarray         # per-level residual RMSE [L]
    frac_saturated: jnp.ndarray
    frac_oob: jnp.ndarray
    flow: jnp.ndarray         # [3] (t-only, full, r-only) RMS pixel flow


@functools.partial(jax.jit, static_argnames=("levels",))
def _make_tracker_ref_device(points_uv, points_idepth, points_color,
                             points_valid, exposure, aff_ab, levels: int):
    n = points_uv.shape[0]
    order = jnp.argsort(~points_valid)            # stable: valid first
    uvs, ids, cols, vals = [], [], [], []
    for l in range(levels):
        s = 0.5 ** l
        n_l = min(n, max(256, n >> l))
        sel = order[:n_l]
        uvs.append(points_uv[sel] * s + (0.5 * s - 0.5))  # pixel-center-consistent
        ids.append(points_idepth[sel])
        cols.append(points_color[sel])
        vals.append(points_valid[sel])
    return TrackerRef(
        uv=tuple(uvs), idepth=tuple(ids), color=tuple(cols), valid=tuple(vals),
        exposure=jnp.asarray(exposure, jnp.float32),
        aff_ab=jnp.asarray(aff_ab, jnp.float32),
    )


def make_tracker_ref(
    points_uv, points_idepth, points_color, points_valid,
    levels: int, exposure: float = 1.0, aff_ab=(0.0, 0.0),
) -> TrackerRef:
    """Build per-level reference lists from level-0 points — ONE jitted
    dispatch (the previous eager per-level slicing cost ~20 tiny device
    ops).

    Coarser levels keep a DECIMATED point set (N >> l, floor 256): a
    40x30 coarse level has ~1.2k pixels — tracking 4k points there is
    pure waste, and the per-level GN cost is linear in the list length.
    Valid points are compacted to the front so the truncation drops
    padding first (reference analog: the semi-dense maps simply shrink
    with the level resolution, CoarseTracker::makeCoarseDepthL0)."""
    return _make_tracker_ref_device(
        points_uv, points_idepth, points_color, points_valid,
        jnp.asarray(exposure, jnp.float32),
        jnp.asarray(aff_ab, jnp.float32), levels)


def _level_residuals(packed, uv, idepth, color, valid, T, ab, intr_l, w, h,
                     cutoff, huber_th):
    """Residuals + per-point weights for one level at relative state (T, ab).

    ``packed`` is the corner-packed (I, dx, dy) level image
    (kernels/interp.pack_corners) — ONE gather per sample instead of
    four; the gathers are what bounds this kernel.

    Returns r [N], omega [N] (0 for saturated/OOB), proj uv' [N, 2],
    in-view mask, saturated mask, and the projection geometry for J."""
    fx, fy, cx, cy = intr_l[0], intr_l[1], intr_l[2], intr_l[3]
    xh = jnp.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy,
                    jnp.ones_like(uv[..., 0])], axis=-1)
    R, t = T[:3, :3], T[:3, 3]
    X = jnp.einsum("ij,pj->pi", R, xh, precision=_HI) + t[None, :] * idepth[:, None]
    z = X[..., 2]
    ok_z = z > 1e-6
    safe_z = jnp.where(ok_z, z, 1.0)
    up, vp = X[..., 0] / safe_z, X[..., 1] / safe_z
    new_id = idepth / safe_z
    u_pix = fx * up + cx
    v_pix = fy * vp + cy
    uv_new = jnp.stack([u_pix, v_pix], axis=-1)
    inb = in_bounds(uv_new, w, h, 2.0) & ok_z & valid

    hit = bilinear_packed(packed, jnp.where(inb[..., None], uv_new, 2.0), 3)
    # affine: r = I_new − e^a·(I_ref) − b  (exposure folded into a by caller)
    r = hit[..., 0] - jnp.exp(ab[0]) * color - ab[1]
    saturated = jnp.abs(r) > cutoff
    abs_r = jnp.abs(r)
    hw = jnp.where(abs_r < huber_th, 1.0, huber_th / jnp.maximum(abs_r, 1e-12))
    omega = jnp.where(inb & ~saturated, hw, 0.0)
    return r, omega, hit, up, vp, new_id, inb, saturated


def _level_system(packed, uv, idepth, color, valid, T, ab, intr_l, w, h,
                  cutoff, huber_th):
    """8x8 GN system for one level (reference: calcRes + calcGSSSE)."""
    fx, fy = intr_l[0], intr_l[1]
    r, omega, hit, up, vp, new_id, inb, sat = _level_residuals(
        packed, uv, idepth, color, valid, T, ab, intr_l, w, h, cutoff, huber_th)
    g = hit[..., 1:3]                                             # [N, 2]
    zeros = jnp.zeros_like(up)
    Jp_u = jnp.stack([new_id * fx, zeros, -new_id * up * fx,
                      -up * vp * fx, (1 + up * up) * fx, -vp * fx], axis=-1)
    Jp_v = jnp.stack([zeros, new_id * fy, -new_id * vp * fy,
                      -(1 + vp * vp) * fy, up * vp * fy, up * fy], axis=-1)
    J_pose = g[..., 0:1] * Jp_u + g[..., 1:2] * Jp_v              # [N, 6]
    J_a = -jnp.exp(ab[0]) * color                                  # [N]
    J_b = -jnp.ones_like(color)
    J = jnp.concatenate([J_pose, J_a[:, None], J_b[:, None]], axis=-1)  # [N, 8]
    H = jnp.einsum("pi,p,pj->ij", J, omega, J, precision=_HI)
    b = jnp.einsum("pi,p->i", J, omega * r, precision=_HI)
    E = jnp.sum(omega * r * r)
    n_ok = jnp.sum(omega > 0)
    n_in = jnp.sum(inb)
    n_sat = jnp.sum(sat & inb)
    return H, b, E, n_ok, n_in, n_sat


@functools.partial(jax.jit, static_argnames=(
    "w", "h", "iters", "cutoff", "huber_th", "lam0", "lam_success",
    "lam_fail", "step_eps"))
def track_level(img3, uv, idepth, color, valid, T0, ab0, intr_l,
                w: int, h: int, iters: int, cutoff: float, huber_th: float,
                lam0: float = 0.01, lam_success: float = 0.5,
                lam_fail: float = 4.0, step_eps: float = 1e-6):
    """LM iterations at one pyramid level (reference: trackNewestCoarse's
    per-level loop with lambda control and small-increment early break —
    a lax.while_loop so converged levels stop paying for iterations).

    ONE residual/system evaluation per iteration: the GN system of the
    accepted state is carried in the loop state, so an accepted step
    pays one evaluation (at the new state) and a rejected step pays one
    (none — the carried system is reused with a larger λ). This mirrors
    the reference's calcRes-once-per-trial structure and halves the
    gather traffic of the previous evaluate-twice formulation."""

    packed = pack_corners(img3)       # once per level call, loop-invariant

    def gn_system(T, ab):
        return _level_system(packed, uv, idepth, color, valid, T, ab,
                             intr_l, w, h, cutoff, huber_th)

    dt = T0.dtype

    def cond(carry):
        T, ab, lam, sysc, it, done = carry
        return (it < iters) & ~done

    def body(carry):
        T, ab, lam, sysc, it, done = carry
        H, b, E, n_ok, n_in, n_sat = sysc
        n_safe = jnp.maximum(n_ok, 1)
        Hd = H.at[jnp.arange(8), jnp.arange(8)].multiply(1.0 + lam)
        Hd = Hd + 1e-4 * jnp.eye(8, dtype=dt) * jnp.maximum(jnp.trace(H) / 8.0, 1e-6)
        step = -jnp.linalg.solve(Hd, b)
        T_new = lie.se3_mul(lie.se3_exp(step[:6]), T)
        ab_new = ab + step[6:8]
        sys2 = gn_system(T_new, ab_new)
        accept = (sys2[2] / jnp.maximum(sys2[3], 1)) < (E / n_safe)

        T = jnp.where(accept, T_new, T).astype(dt)
        ab = jnp.where(accept, ab_new, ab).astype(dt)
        sysc = jax.tree.map(lambda a, b_: jnp.where(accept, b_, a), sysc, sys2)
        lam = jnp.where(accept, jnp.maximum(lam * lam_success, 1e-5),
                        lam * lam_fail).astype(dt)
        # reference: "inc too small" break once an accepted step stalls;
        # also stop once λ has blown up (every step rejected)
        done = (accept & (jnp.max(jnp.abs(step)) < step_eps)) | (lam > 1e3)
        return (T, ab, lam, sysc, it + 1, done)

    sys0 = gn_system(T0, ab0.astype(dt))
    T, ab, lam, sysc, _, _ = jax.lax.while_loop(
        cond, body,
        (T0, ab0.astype(dt), jnp.asarray(lam0, dt), sys0,
         jnp.int32(0), jnp.asarray(False)))
    H, b, E, n_ok, n_in, n_sat = sysc
    rmse = jnp.sqrt(E / jnp.maximum(n_ok, 1))
    return T, ab, rmse, n_ok, n_in, n_sat


def track_frame(
    pyr_new,                 # list of [H_l, W_l, 3] new-frame pyramid
    ref: TrackerRef,
    T_inits,                 # [K, 4, 4] motion hypotheses (refToNew)
    ab_init,                 # [2]
    intr,                    # [4] level-0 intrinsics
    cfg,
    new_exposure: float = 1.0,
) -> TrackResult:
    """Full pyramidal track: batched hypotheses at the coarsest levels,
    winner refined to level 0 (reference: FullSystem::trackNewCoarse +
    CoarseTracker::trackNewestCoarse)."""
    levels = len(pyr_new)
    tcfg = cfg.tracker
    iters = list(tcfg.max_iterations) + [50] * levels

    # coarse stage: all hypotheses at the top two levels. The BATCHED
    # ladder runs few iterations per level — under vmap every lane pays
    # for the slowest, so a handful of LM steps to rank the hypotheses
    # is the right budget; the winner gets the full per-level iteration
    # counts in the fine stage (the reference instead early-exits its
    # SEQUENTIAL ladder at `res < 1.5 x best`, CoarseTracker.cc:~L600).
    K = T_inits.shape[0]
    rmses = None
    T_cand, ab_cand = T_inits, jnp.broadcast_to(ab_init, (K, 2))
    for l in range(levels - 1, max(levels - 3, 0), -1):
        intr_l = level_intrinsics(intr, l)
        h, w = pyr_new[l].shape[0], pyr_new[l].shape[1]
        fn = jax.vmap(
            lambda T0, ab0: track_level(
                pyr_new[l], ref.uv[l], ref.idepth[l], ref.color[l], ref.valid[l],
                T0, ab0, intr_l, w, h, min(int(iters[l]), 12),
                float(tcfg.coarse_cutoff_th * (2.0 ** l)), float(tcfg.huber_th),
                lam0=float(tcfg.lambda_initial),
                lam_success=float(tcfg.lambda_success),
                lam_fail=float(tcfg.lambda_fail),
                step_eps=float(tcfg.step_eps)))
        T_cand, ab_cand, rmses, n_ok, n_in, n_sat = fn(T_cand, ab_cand)
    best = jnp.argmin(jnp.where(jnp.isfinite(rmses), rmses, jnp.inf))
    T, ab = T_cand[best], ab_cand[best]

    # fine stage: winner through the remaining levels
    rmse_per_level = [jnp.float32(0.0)] * levels
    n_ok = n_in = n_sat = jnp.int32(0)
    for l in range(max(levels - 3, 0), -1, -1):
        intr_l = level_intrinsics(intr, l)
        h, w = pyr_new[l].shape[0], pyr_new[l].shape[1]
        T, ab, rmse, n_ok, n_in, n_sat = track_level(
            pyr_new[l], ref.uv[l], ref.idepth[l], ref.color[l], ref.valid[l],
            T, ab, intr_l, w, h, int(iters[l]),
            float(tcfg.coarse_cutoff_th * (2.0 ** l)), float(tcfg.huber_th),
            lam0=float(tcfg.lambda_initial),
            lam_success=float(tcfg.lambda_success),
            lam_fail=float(tcfg.lambda_fail),
            step_eps=float(tcfg.step_eps))
        rmse_per_level[l] = rmse

    # flow indicators at level 0 (reference: lastFlowIndicators)
    intr0 = intr
    flow = _flow_indicators(ref, T, intr0)

    frac_sat = n_sat / jnp.maximum(n_in, 1)
    frac_oob = 1.0 - n_in / jnp.maximum(jnp.sum(ref.valid[0]), 1)
    return TrackResult(
        T=T, ab=ab, rmse=jnp.stack(rmse_per_level),
        frac_saturated=frac_sat, frac_oob=frac_oob, flow=flow,
    )


@jax.jit
def _flow_indicators(ref: TrackerRef, T, intr):
    """RMS pixel displacement under (t-only, full, R-only) motion —
    the keyframe-decision inputs (reference: CoarseTracker flow vecs)."""
    uv, idep, valid = ref.uv[0], ref.idepth[0], ref.valid[0]
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    xh = jnp.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy,
                    jnp.ones_like(uv[..., 0])], axis=-1)

    def proj(R, t):
        X = jnp.einsum("ij,pj->pi", R, xh, precision=_HI) \
            + t[None, :] * idep[:, None]
        z = jnp.maximum(X[..., 2], 1e-6)
        return jnp.stack([fx * X[..., 0] / z + cx, fy * X[..., 1] / z + cy], axis=-1)

    R, t = T[:3, :3], T[:3, 3]
    eye = jnp.eye(3, dtype=T.dtype)
    disp_t = proj(eye, t) - uv
    disp_full = proj(R, t) - uv
    disp_r = proj(R, jnp.zeros(3, T.dtype)) - uv
    w = valid.astype(uv.dtype)
    n = jnp.maximum(jnp.sum(w), 1.0)

    def rms(d):
        return jnp.sqrt(jnp.sum(w * jnp.sum(d * d, axis=-1)) / n)

    return jnp.stack([rms(disp_t), rms(disp_full), rms(disp_r)])


def motion_hypotheses(T_const_vel, num: int = 27) -> jnp.ndarray:
    """[K, 4, 4] initial guesses: constant velocity, half, double, zero,
    plus small-rotation perturbations of the constant-velocity guess
    (reference: FullSystem::trackNewCoarse's lastF_2_fh_tries ladder)."""
    xi = lie.se3_log(jnp.asarray(T_const_vel, jnp.float32))
    cands = [xi, 0.5 * xi, 2.0 * xi, jnp.zeros(6, jnp.float32)]
    rot = 0.02
    deltas = []
    for ax in range(3):
        for sgn in (1.0, -1.0):
            d = jnp.zeros(6, jnp.float32).at[3 + ax].set(sgn * rot)
            deltas.append(d)
    # pairwise axis combos to fill out the ladder
    for ax1 in range(3):
        for ax2 in range(ax1 + 1, 3):
            for s1 in (1.0, -1.0):
                for s2 in (1.0, -1.0):
                    d = (jnp.zeros(6, jnp.float32)
                         .at[3 + ax1].set(s1 * rot).at[3 + ax2].set(s2 * rot))
                    deltas.append(d)
    for d in deltas:
        cands.append(xi + d)
    cands = cands[:num]
    while len(cands) < num:
        cands.append(xi)
    return lie.se3_exp(jnp.stack(cands))
