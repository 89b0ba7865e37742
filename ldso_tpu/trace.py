"""Immature-point epipolar depth tracing.

JAX redesign of the reference's ``ImmaturePoint::traceOn``
(reference: n-lalanne/LDSO src/internal/ImmaturePoint.cc): for every
candidate point, search its inverse-depth interval's epipolar segment in
a new frame with the 8-pattern SSD, refine sub-pixel with a few GN steps
along the line, shrink [idepth_min, idepth_max], and classify
GOOD / OOB / OUTLIER / SKIPPED / BADCONDITION.

The reference traces points one by one with a dynamic number of line
samples (≤100); here every immature point evaluates a FIXED K-sample
discretization of its (clamped) segment in one batched program —
samples × pattern × points all vectorized.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ldso_tpu.core.window import PATTERN_OFFSETS
from ldso_tpu.kernels.interp import (bilinear33, bilinear_packed, in_bounds,
                                     pack_corners)
from ldso_tpu.math import lie

_HI = jax.lax.Precision.HIGHEST

# status codes (reference: ImmaturePointStatus)
GOOD, OOB, OUTLIER, SKIPPED, BADCONDITION, UNINITIALIZED = 0, 1, 2, 3, 4, 5


class TraceResult(NamedTuple):
    idepth_min: jnp.ndarray   # [N]
    idepth_max: jnp.ndarray   # [N]
    status: jnp.ndarray       # [N] i32
    quality: jnp.ndarray      # [N] best/second-best energy ratio
    best_uv: jnp.ndarray      # [N, 2] matched position in the new frame
    best_idepth: jnp.ndarray  # [N] idepth at the matched position


@functools.partial(jax.jit, static_argnames=("num_samples", "gn_iters",
                                             "sweep_pattern"))
def trace_points(
    img3_new,                # [H, W, 3] new frame (level 0)
    uv,                      # [N, 2] host pixels
    color,                   # [N, 8] host pattern intensities
    idepth_min,              # [N]
    idepth_max,              # [N]
    valid,                   # [N] bool
    T_hn,                    # [4, 4] or [N, 4, 4] hostToNew SE3 (per point)
    ab_hn,                   # [2] or [N, 2] relative affine: I_n ≈ alpha·I_h + beta
    intr,                    # [4]
    num_samples: int = 64,
    gn_iters: int = 3,
    max_pix_search_frac: float = 0.027,
    outlier_energy: float = 1800.0,   # reference: setting_trace_energy-ish gate (12²·8 + slack)
    min_quality: float = 3.0,
    step_size: float = 1.0,
    slack_interval: float = 1.5,      # reference: don't re-search intervals already this tight (px)
    extra_slack: float = 0.1,         # setting_trace_extraSlackOnTH on the energy gate
    gn_threshold: float = 0.1,        # subpixel GN convergence step (px)
    sweep_pattern: int = 8,           # offsets scored in the discrete sweep
) -> TraceResult:
    h, w = img3_new.shape[0], img3_new.shape[1]
    N = uv.shape[0]
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    pat = jnp.asarray(PATTERN_OFFSETS)
    if T_hn.ndim == 2:
        T_hn = jnp.broadcast_to(T_hn, (N, 4, 4))
    if ab_hn.ndim == 1:
        ab_hn = jnp.broadcast_to(ab_hn, (N, 2))
    R, t = T_hn[:, :3, :3], T_hn[:, :3, 3]                        # [N,3,3], [N,3]

    # central ray: pr = K·R·K⁻¹·(u,v,1) in "pixel-homogeneous" form, Kt = K·t
    xh = jnp.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy,
                    jnp.ones_like(uv[..., 0])], axis=-1)          # [N, 3]
    Rx = jnp.einsum("pij,pj->pi", R, xh, precision=_HI)           # [N, 3]
    pr = jnp.stack([fx * Rx[..., 0] + cx * Rx[..., 2],
                    fy * Rx[..., 1] + cy * Rx[..., 2],
                    Rx[..., 2]], axis=-1)
    Kt = jnp.stack([fx * t[:, 0] + cx * t[:, 2],
                    fy * t[:, 1] + cy * t[:, 2], t[:, 2]], axis=-1)  # [N, 3]

    def project_at(d):
        """pixel position at inverse depth d: (pr + d·Kt) dehomogenized."""
        ph = pr + d[..., None] * Kt
        z = ph[..., 2]
        ok = z > 1e-6
        z = jnp.where(ok, z, 1.0)
        return jnp.stack([ph[..., 0] / z, ph[..., 1] / z], axis=-1), ok

    p_min, ok_min = project_at(idepth_min)
    p_max, ok_max = project_at(jnp.minimum(idepth_max, 1e8))
    max_search = max_pix_search_frac * (w + h)
    # unbounded (or behind-camera) far end: walk maxPixSearch along the
    # ANALYTIC epipolar direction d(uv)/d(idepth) at idepth_min
    # (reference: traceOn's !isfinite(idepth_max) branch)
    z_min = pr[..., 2] + idepth_min * Kt[:, 2]
    epi = jnp.stack([Kt[:, 0] * pr[..., 2] - pr[..., 0] * Kt[:, 2],
                     Kt[:, 1] * pr[..., 2] - pr[..., 1] * Kt[:, 2]], axis=-1)
    epi = epi * jnp.sign(z_min)[..., None]
    epi_n = jnp.linalg.norm(epi, axis=-1, keepdims=True)
    epi_unit = epi / jnp.maximum(epi_n, 1e-12)
    unbounded = ~ok_max | (idepth_max > 1e6)
    p_max = jnp.where(unbounded[..., None],
                      p_min + max_search * epi_unit, p_max)
    # direction & clamped search length (reference: maxPixSearch = 0.027(w+h))
    seg = p_max - p_min
    seg_len = jnp.linalg.norm(seg, axis=-1)
    too_short = seg_len < slack_interval
    dir_ = seg / jnp.maximum(seg_len, 1e-8)[..., None]
    length = jnp.minimum(seg_len, max_search)
    # discretize from p_min toward p_max
    steps = jnp.linspace(0.0, 1.0, num_samples)
    sample_uv = p_min[:, None, :] + (length[:, None] * steps[None, :])[..., None] * dir_[:, None, :]  # [N, K, 2]

    # pattern SSD at every sample (affine-corrected host colors). The
    # sweep needs INTENSITY only — gather from a corner-packed intensity
    # plane (one 4-channel gather per sample instead of four 3-channel
    # ones; this N·K·8-sample sweep is the kernel's entire HBM bill)
    packed_I = pack_corners(img3_new[..., :1])                     # [H, W, 4]
    # full (I,dx,dy) corner pack for the GN refine + condition check:
    # one 12-channel gather per sample instead of four 3-channel ones
    # (the refine's 3·N·8 samples were ~40% of the kernel's gather count)
    packed3 = pack_corners(img3_new)                               # [H, W, 12]
    pred_full = ab_hn[:, 0:1] * color + ab_hn[:, 1:2]              # [N, 8]
    # the N·K·|pattern| gather sweep is the kernel's entire HBM bill;
    # sweep_pattern=4 scores the four pattern extremes (the max-spread
    # diamond (0,∓2)/(∓2,0)) — half the gathers — and leaves the
    # full-8 evaluation to the GN subpixel refine at the winner
    # (reference sweeps all 8 at every step; ATE probe: no measurable
    # drift cost, scripts/ate_probe.py LDSO_SWEEP)
    if sweep_pattern >= 8:
        sweep_idx = tuple(range(8))
    elif sweep_pattern == 4:
        sweep_idx = (0, 3, 5, 7)
    else:
        sweep_idx = (0, 4, 7)[: max(sweep_pattern, 1)]
    pat_s = pat[jnp.asarray(sweep_idx)]
    pred = pred_full[:, jnp.asarray(sweep_idx)]
    samp = sample_uv[:, :, None, :] + pat_s[None, None, :, :]      # [N, K, S, 2]
    inb = jnp.all(in_bounds(samp, w, h, 2.0), axis=-1)             # [N, K]
    samp = jnp.where(inb[..., None, None], samp, 2.0)
    hit_I = bilinear_packed(packed_I, samp, 1)[..., 0]             # [N, K, 8]
    diff = hit_I - pred[:, None, :]
    ssd = jnp.sum(diff * diff, axis=-1)                            # [N, K]
    ssd = jnp.where(inb, ssd, jnp.inf)

    best_k = jnp.argmin(ssd, axis=-1)
    best_e = jnp.min(ssd, axis=-1)
    # second best outside ±2 samples (reference: setting_minTraceTestRadius)
    kk = jnp.arange(num_samples)[None, :]
    excl = jnp.abs(kk - best_k[:, None]) <= 2
    second_e = jnp.min(jnp.where(excl, jnp.inf, ssd), axis=-1)
    quality = second_e / jnp.maximum(best_e, 1e-6)

    best_uv = jnp.take_along_axis(sample_uv, best_k[:, None, None].repeat(2, -1), axis=1)[:, 0, :]

    # GN sub-pixel refinement along the line (reference: ≤3 iterations)
    def gn_step(carry, _):
        buv = carry
        sampk = buv[:, None, :] + pat[None, :, :]
        hitk = bilinear_packed(packed3, sampk, 3)
        rk = hitk[..., 0] - pred_full
        gk = jnp.sum(hitk[..., 1:3] * dir_[:, None, :], axis=-1)   # dI/ds
        H = jnp.sum(gk * gk, axis=-1)
        b = jnp.sum(gk * rk, axis=-1)
        step = -b / jnp.maximum(H, 1e-6)
        step = jnp.clip(step, -step_size, step_size)
        # converged points stop moving (reference: GN break on small step)
        step = jnp.where(jnp.abs(step) < gn_threshold, 0.0, step)
        return buv + step[..., None] * dir_, None

    best_uv, _ = jax.lax.scan(gn_step, best_uv, None, length=gn_iters)

    # convert matched pixel back to inverse depth using the better-conditioned axis
    # u' = (pr.x + d·Kt.x)/(pr.z + d·Kt.z)  =>  d = (pr.z·u' − pr.x)/(Kt.x − Kt.z·u')
    err_px = 1.0 + 0.5 * step_size
    use_u = jnp.abs(dir_[..., 0]) > jnp.abs(dir_[..., 1])

    def idepth_from(uv_pt):
        du = (pr[..., 2] * uv_pt[..., 0] - pr[..., 0]) / (
            Kt[:, 0] - Kt[:, 2] * uv_pt[..., 0])
        dv = (pr[..., 2] * uv_pt[..., 1] - pr[..., 1]) / (
            Kt[:, 1] - Kt[:, 2] * uv_pt[..., 1])
        return jnp.where(use_u, du, dv)

    d_lo = idepth_from(best_uv - err_px * dir_)
    d_hi = idepth_from(best_uv + err_px * dir_)
    new_min = jnp.minimum(d_lo, d_hi)
    new_max = jnp.maximum(d_lo, d_hi)
    best_idepth = idepth_from(best_uv)

    # condition check: gradient along epipolar direction at the match
    hit_best = bilinear_packed(packed3, best_uv, 3)
    g_along = jnp.abs(jnp.sum(hit_best[..., 1:3] * dir_, axis=-1))

    searched_oob = ~ok_min | ~jnp.any(inb, axis=-1)
    # energy gate scales with the number of swept pattern points
    is_outlier = best_e > (outlier_energy * len(sweep_idx) / 8.0) \
        * (1.0 + extra_slack)
    bad_cond = (g_along < 1.0) | (new_max < new_min) | (new_min < -0.1)
    low_quality = quality < min_quality

    status = jnp.full(uv.shape[0], GOOD, jnp.int32)
    status = jnp.where(low_quality, OUTLIER, status)
    status = jnp.where(bad_cond, BADCONDITION, status)
    status = jnp.where(is_outlier, OUTLIER, status)
    status = jnp.where(too_short, SKIPPED, status)
    status = jnp.where(searched_oob, OOB, status)
    status = jnp.where(~valid, UNINITIALIZED, status)

    good = status == GOOD
    out_min = jnp.where(good, jnp.maximum(new_min, 0.0), idepth_min)
    out_max = jnp.where(good, new_max, idepth_max)
    return TraceResult(
        idepth_min=out_min, idepth_max=out_max, status=status,
        quality=quality, best_uv=best_uv, best_idepth=best_idepth,
    )


@functools.partial(jax.jit, static_argnames=("iters",))
def optimize_idepth(
    win_images,              # [F, H, W, 3]
    frame_valid,             # [F] bool
    T_rel,                   # [F, 4, 4] hostToTarget for each slot
    alpha,                   # [F] affine gain host->target
    beta,                    # [F] affine offset
    uv,                      # [N, 2] candidate pixels (host frame)
    color,                   # [N, 8]
    idepth0,                 # [N] initial inverse depth
    valid,                   # [N]
    intr,                    # [4]
    host_slot,               # scalar int (candidates share one host)
    iters: int = 3,
    huber_th: float = 9.0,
):
    """1-dof GN on inverse depth against every valid window frame —
    immature-point activation (reference: FullSystem::optimizeImmaturePoint
    with ImmaturePointTemporaryResidual). Returns (idepth, H_dd, energy)."""
    F = win_images.shape[0]
    h, w = win_images.shape[1], win_images.shape[2]
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    pat = jnp.asarray(PATTERN_OFFSETS)
    uvp = uv[:, None, :] + pat[None]                               # [N, 8, 2]
    xh = jnp.stack([(uvp[..., 0] - cx) / fx, (uvp[..., 1] - cy) / fy,
                    jnp.ones_like(uvp[..., 0])], axis=-1)          # [N, 8, 3]

    def system(d):
        Hd = jnp.zeros_like(d)
        bd = jnp.zeros_like(d)
        E = jnp.zeros_like(d)
        cnt = jnp.zeros_like(d)
        for f in range(F):
            ok_f = frame_valid[f] & (f != host_slot)
            R, t = T_rel[f, :3, :3], T_rel[f, :3, 3]
            X = jnp.einsum("ij,pkj->pki", R, xh, precision=_HI) + t[None, None, :] * d[:, None, None]
            z = X[..., 2]
            okz = z > 1e-6
            zs = jnp.where(okz, z, 1.0)
            up, vp = X[..., 0] / zs, X[..., 1] / zs
            uvn = jnp.stack([fx * up + cx, fy * vp + cy], axis=-1)
            inb = in_bounds(uvn, w, h, 2.0) & okz & ok_f & valid[:, None]
            hit = bilinear33(win_images[f], uvn)
            r = hit[..., 0] - alpha[f] * color - beta[f]
            dre = 1.0 / zs
            Jd_u = fx * dre * (t[0] - t[2] * up)
            Jd_v = fy * dre * (t[1] - t[2] * vp)
            Jd = hit[..., 1] * Jd_u + hit[..., 2] * Jd_v
            abs_r = jnp.abs(r)
            hw = jnp.where(abs_r < huber_th, 1.0, huber_th / jnp.maximum(abs_r, 1e-12))
            om = jnp.where(inb, hw, 0.0)
            Hd += jnp.sum(om * Jd * Jd, axis=-1)
            bd += jnp.sum(om * Jd * r, axis=-1)
            E += jnp.sum(om * r * r * (2.0 - hw), axis=-1)
            cnt += jnp.sum(inb, axis=-1)
        return Hd, bd, E, cnt

    d = idepth0
    for _ in range(iters):
        Hd, bd, E, cnt = system(d)
        step = -bd / (Hd + 1e-6)
        d = jnp.clip(d + step, 1e-5, 50.0)
    Hd, bd, E, cnt = system(d)
    return d, Hd, E, cnt


@functools.partial(jax.jit, static_argnames=("iters",))
def optimize_idepth_bank(
    win_images,              # [F, H, W, 3]
    frame_valid,             # [F] bool
    T_all,                   # [F, 4, 4] current worldToCam of every slot
    x_affine,                # [F, 8] window states (affine dims used)
    exposure_all,            # [F]
    uv,                      # [N, 2] candidate pixels (in their host frame)
    color,                   # [N, 8]
    idepth0,                 # [N]
    valid,                   # [N]
    host_slot,               # [N] i32 per-candidate host window slot
    intr,                    # [4]
    iters: int = 3,
    huber_th: float = 9.0,
):
    """Per-point-host variant of :func:`optimize_idepth`: ONE dispatch
    covers candidates from EVERY host slot (the per-slot host loop paid
    one device round trip per slot — reference:
    FullSystem::activatePointsMT runs all hosts in one parallel-for
    too). Relative transforms and affine transfer are
    gathered per point from the window state on device."""
    F = win_images.shape[0]
    h, w = win_images.shape[1], win_images.shape[2]
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    pat = jnp.asarray(PATTERN_OFFSETS)
    uvp = uv[:, None, :] + pat[None]                               # [N, 8, 2]
    xh = jnp.stack([(uvp[..., 0] - cx) / fx, (uvp[..., 1] - cy) / fy,
                    jnp.ones_like(uvp[..., 0])], axis=-1)          # [N, 8, 3]

    T_inv_h = lie.se3_inverse(T_all)[host_slot]                    # [N, 4, 4]
    ea = exposure_all * jnp.exp(x_affine[:, 6])                    # [F]
    ea_h = ea[host_slot]                                           # [N]
    b_h = x_affine[host_slot, 7]
    # corner-packed window images: one 12-channel gather per sample
    # instead of four (this GN's F·N·8·(iters+1) gather sweep is the
    # whole activation cost)
    packed = [pack_corners(win_images[f]) for f in range(F)]

    def system(d):
        Hd = jnp.zeros_like(d)
        bd = jnp.zeros_like(d)
        E = jnp.zeros_like(d)
        cnt = jnp.zeros_like(d)
        for f in range(F):
            T_rel = jnp.einsum("ij,pjk->pik", T_all[f], T_inv_h,
                               precision=_HI)                      # [N, 4, 4]
            R, t = T_rel[:, :3, :3], T_rel[:, :3, 3]
            alpha = ea[f] / jnp.maximum(ea_h, 1e-12)               # [N]
            beta = x_affine[f, 7] - alpha * b_h
            ok_f = frame_valid[f] & (host_slot != f) & valid
            X = jnp.einsum("pij,pkj->pki", R, xh, precision=_HI) \
                + t[:, None, :] * d[:, None, None]
            z = X[..., 2]
            okz = z > 1e-6
            zs = jnp.where(okz, z, 1.0)
            up, vp = X[..., 0] / zs, X[..., 1] / zs
            uvn = jnp.stack([fx * up + cx, fy * vp + cy], axis=-1)
            inb = in_bounds(uvn, w, h, 2.0) & okz & ok_f[:, None]
            hit = bilinear_packed(packed[f], uvn, 3)
            r = hit[..., 0] - alpha[:, None] * color - beta[:, None]
            dre = 1.0 / zs
            Jd_u = fx * dre * (t[:, 0:1] - t[:, 2:3] * up)
            Jd_v = fy * dre * (t[:, 1:2] - t[:, 2:3] * vp)
            Jd = hit[..., 1] * Jd_u + hit[..., 2] * Jd_v
            abs_r = jnp.abs(r)
            hw = jnp.where(abs_r < huber_th, 1.0,
                           huber_th / jnp.maximum(abs_r, 1e-12))
            om = jnp.where(inb, hw, 0.0)
            Hd += jnp.sum(om * Jd * Jd, axis=-1)
            bd += jnp.sum(om * Jd * r, axis=-1)
            E += jnp.sum(om * r * r * (2.0 - hw), axis=-1)
            cnt += jnp.sum(inb, axis=-1)
        return Hd, bd, E, cnt

    d = idepth0
    for _ in range(iters):
        Hd, bd, E, cnt = system(d)
        step = -bd / (Hd + 1e-6)
        d = jnp.clip(d + step, 1e-5, 50.0)
    Hd, bd, E, cnt = system(d)
    return dict(idepth=d, H_dd=Hd, energy=E, count=cnt)


@functools.partial(jax.jit, static_argnames=("iters",))
def activate_candidates_device(
    win_images, frame_valid, T_all, x_affine, exposure_all,
    bank, intr, min_quality: float,
    iters: int = 3, huber_th: float = 9.0,
):
    """Self-gating variant of :func:`optimize_idepth_bank`: the
    activation-candidate mask and initial idepth are computed ON DEVICE
    from the live bank, so the whole activation GN can be DISPATCHED
    before the keyframe's bank snapshot is read back — the dispatch
    overlaps the snapshot's readback instead of paying its own
    (reference: activatePointsMT's candidate gate + optimizeImmaturePoint,
    FullSystem.cc:~L500-600)."""
    can = (bank.valid & (bank.last_status == GOOD)
           & (bank.quality > min_quality)
           & ~jnp.isnan(bank.idepth_max)
           & ((bank.idepth_max + bank.idepth_min) > 0))
    d0 = jnp.clip(0.5 * (jnp.where(can, bank.idepth_min, 0.0)
                         + jnp.where(can, bank.idepth_max, 1.0)),
                  1e-3, 50.0)
    out = optimize_idepth_bank(
        win_images, frame_valid, T_all, x_affine, exposure_all,
        bank.uv, bank.color, d0, can, bank.host_slot.astype(jnp.int32),
        intr, iters=iters, huber_th=huber_th)
    out["can"] = can
    return out
