"""Photometric residual / Jacobian evaluation and Gauss-Newton assembly.

JAX redesign of the reference's optimization hot path
(reference: n-lalanne/LDSO ``PointFrameResidual::linearize`` in
src/internal/Residuals.cc, the SSE accumulators in
``MatrixAccumulators.h``, and ``AccumulatedTop/SCHessian``): instead of
per-residual C++ loops feeding hierarchical SIMD accumulators, every
(point, target) pair in the window is evaluated as one dense batch and
the entire reduced camera system becomes a single dense matmul
``H = Jᵀ·Ω·J`` over ~100k residual rows, with the per-point Schur
pieces as batched einsums (SURVEY.md §5.8).

First-Estimate-Jacobian semantics (correctness-critical, mirrors the
reference exactly):
  * geometric Jacobian factors (projection derivatives, adjoint
    transport, affine-transfer coefficient) are evaluated at the FEJ
    states: ``T_eval`` poses, ``x_zero`` affine, ``c_zero`` intrinsics,
    ``idepth_zero`` — reference: PRE_RTll_0/PRE_tTll_0 use the
    evaluation-point poses, projectPoint uses idepth_zero.
  * the residual intensity lookup and image gradients use the CURRENT
    states — reference: PRE_KRKiTll/PRE_KtTll and dIl interpolation.

Jacobian factorization follows the reference: the 2x(6+4+1) projection
Jacobian is computed once per (point, target) at the central pattern
pixel and shared across the 8 pattern samples; per-sample image
gradients multiply in (RawResidualJacobian's Jpdxi/Jpdc/Jpdd ⊗ JIdx).

State layout of the reduced system (dimension D = 8F+4):
  columns [8·s : 8·s+8] = frame slot s: [xi(6), a, b]; columns [8F:] =
  intrinsics [fx fy cx cy].
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ldso_tpu.core.window import PATTERN_OFFSETS, Window, state_delta
from ldso_tpu.kernels.interp import (bilinear33, bilinear_packed, in_bounds,
                                     pack_corners)
from ldso_tpu.math import lie

_HI = jax.lax.Precision.HIGHEST


class BASystem(NamedTuple):
    """Everything the solver needs, plus per-pair diagnostics for the host."""

    H: jnp.ndarray          # [D, D] reduced camera system (before Schur/prior)
    b: jnp.ndarray          # [D] gradient Jᵀ Ω r
    H_xd: jnp.ndarray       # [P, D] camera-idepth cross blocks
    H_dd: jnp.ndarray       # [P] idepth Hessian
    b_d: jnp.ndarray        # [P] idepth gradient
    energy: jnp.ndarray     # scalar Huber energy (reference formula)
    e_pair: jnp.ndarray     # [P, F] per (point, target) energy
    valid_pair: jnp.ndarray # bool [P, F] pair produced a usable residual
    oob_pair: jnp.ndarray   # bool [P, F] pair was masked-in but projected OOB
    num_res: jnp.ndarray    # scalar count of valid pattern residuals


class PairPrecalc(NamedTuple):
    """Per (host, target) precomputed quantities (reference:
    FrameFramePrecalc::set — refreshed every linearization)."""

    R_cur: jnp.ndarray      # [F, F, 3, 3]
    t_cur: jnp.ndarray      # [F, F, 3]
    R_fej: jnp.ndarray      # [F, F, 3, 3]
    t_fej: jnp.ndarray      # [F, F, 3]
    adj_fej: jnp.ndarray    # [F, F, 6, 6] Adjoint of FEJ relative pose
    alpha_cur: jnp.ndarray  # [F, F] e^{a_rel} at current affine states
    alpha_fej: jnp.ndarray  # [F, F] e^{a_rel} at FEJ affine states
    b_host_cur: jnp.ndarray # [F] current host b
    b_host_fej: jnp.ndarray # [F] FEJ host b
    b_tgt_cur: jnp.ndarray  # [F] current target b


def precompute_pairs(win: Window) -> PairPrecalc:
    T_cur = lie.se3_mul(lie.se3_exp(win.x[:, :6]), win.T_eval)        # [F,4,4]
    Tc_inv = lie.se3_inverse(T_cur)
    Te_inv = lie.se3_inverse(win.T_eval)
    # rel[h, t] = T_t · T_h⁻¹
    rel_cur = jnp.einsum("tij,hjk->htik", T_cur, Tc_inv, precision=_HI)
    rel_fej = jnp.einsum("tij,hjk->htik", win.T_eval, Te_inv, precision=_HI)
    adj_fej = lie.se3_adjoint(rel_fej)

    ea_cur = win.exposure * jnp.exp(win.x[:, 6])      # [F] e_i · exp(a_i)
    ea_fej = win.exposure * jnp.exp(win.x_zero[:, 6])
    alpha_cur = ea_cur[None, :] / ea_cur[:, None]     # [host, target]
    alpha_fej = ea_fej[None, :] / ea_fej[:, None]
    return PairPrecalc(
        R_cur=rel_cur[..., :3, :3], t_cur=rel_cur[..., :3, 3],
        R_fej=rel_fej[..., :3, :3], t_fej=rel_fej[..., :3, 3],
        adj_fej=adj_fej,
        alpha_cur=alpha_cur, alpha_fej=alpha_fej,
        b_host_cur=win.x[:, 7], b_host_fej=win.x_zero[:, 7],
        b_tgt_cur=win.x[:, 7],
    )


def _normalized_dirs(uv, intr):
    """Pixel(s) -> normalized host dirs [..., 3] (z = 1)."""
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    return jnp.stack([x, y, jnp.ones_like(x)], axis=-1)


def _pose_jacobian(up, vp, new_id, fx, fy):
    """d(pixel)/d(left-increment of relative pose), [..., 2, 6].

    up, vp: normalized target coords; new_id: idepth in target frame.
    Tangent order [rho, phi] (translation first), matching math/lie.py.
    Reference: RawResidualJacobian Jpdxi (src/internal/Residuals.cc)."""
    z = jnp.zeros_like(up)
    row_u = jnp.stack(
        [new_id * fx, z, -new_id * up * fx,
         -up * vp * fx, (1.0 + up * up) * fx, -vp * fx], axis=-1)
    row_v = jnp.stack(
        [z, new_id * fy, -new_id * vp * fy,
         -(1.0 + vp * vp) * fy, up * vp * fy, up * fy], axis=-1)
    return jnp.stack([row_u, row_v], axis=-2)


def _cam_jacobian(up, vp, drescale, xh, R, fx, fy, intr):
    """d(pixel)/d(intrinsics fx fy cx cy), [..., 2, 4].

    Includes both the direct target-projection dependence and the
    host-backprojection chain (reference: Jpdc in Residuals.cc)."""
    # d(normalized host dir)/dc — only x,y components nonzero
    fx0, fy0 = intr[0], intr[1]
    dxh = jnp.stack([-xh[..., 0] / fx0, jnp.zeros_like(up), -1.0 / fx0 * jnp.ones_like(up),
                     jnp.zeros_like(up)], axis=-1)   # [..., 4] x-component wrt (fx,fy,cx,cy)
    dyh = jnp.stack([jnp.zeros_like(up), -xh[..., 1] / fy0, jnp.zeros_like(up),
                     -1.0 / fy0 * jnp.ones_like(up)], axis=-1)
    # dX/dc = R[:,0]·dxh + R[:,1]·dyh  -> [..., 3, 4]
    dX = R[..., :, 0:1] * dxh[..., None, :] + R[..., :, 1:2] * dyh[..., None, :]
    dup = drescale[..., None] * (dX[..., 0, :] - up[..., None] * dX[..., 2, :])
    dvp = drescale[..., None] * (dX[..., 1, :] - vp[..., None] * dX[..., 2, :])
    du_pix = fx * dup
    dv_pix = fy * dvp
    # direct dependence of Ku = fx·up + cx on (fx, fy, cx, cy)
    du_pix = du_pix.at[..., 0].add(up)
    du_pix = du_pix.at[..., 2].add(1.0)
    dv_pix = dv_pix.at[..., 1].add(vp)
    dv_pix = dv_pix.at[..., 3].add(1.0)
    return jnp.stack([du_pix, dv_pix], axis=-2)


@functools.partial(jax.jit, static_argnames=("huber_th", "outlier_sum", "mode"))
def assemble(
    win: Window,
    huber_th: float = 9.0,
    outlier_sum: float = 2500.0,
    mode: str = "active",
) -> BASystem:
    """Linearize all residuals and assemble the Gauss-Newton system.

    mode="active": b uses current residuals (the BA path).
    mode="fej":    b uses residuals transported to the linearization point
                   r₀ = r − J·Δstate (reference: EFResidual::fixLinearization
                   res_toZeroF — the marginalization path).
    """
    F = win.num_frames
    P = win.num_points
    D = 8 * F + 4
    pat = jnp.asarray(PATTERN_OFFSETS)              # [8, 2]
    pre = precompute_pairs(win)

    fx, fy = win.c[0], win.c[1]
    fx0, fy0 = win.c_zero[0], win.c_zero[1]
    H_img, W_img = win.images.shape[1], win.images.shape[2]

    # host-frame geometry
    uv_pat = win.p_uv[:, None, :] + pat[None, :, :]                 # [P, 8, 2]
    xh_cur = _normalized_dirs(uv_pat, win.c)                         # [P, 8, 3]
    xh_fej_c = _normalized_dirs(win.p_uv, win.c_zero)                # [P, 3] central

    host = win.p_host                                                # [P]
    oh_host = jax.nn.one_hot(host, F, dtype=win.p_uv.dtype)          # [P, F]

    # corner-packed images: every bilinear sample becomes ONE gather
    # instead of four (the gathers are the HBM-latency-bound part of
    # this kernel); packing is a cheap dense op amortized per call.
    packed = jax.vmap(pack_corners)(win.images)                      # [F,H,W,12]

    # per-point pair quantities: one-hot matmuls instead of [host, f]
    # row gathers (tiny tables)
    R_cur_p = jnp.einsum("pg,gfij->pfij", oh_host, pre.R_cur, precision=_HI)
    t_cur_p = jnp.einsum("pg,gfi->pfi", oh_host, pre.t_cur, precision=_HI)
    R_fej_p = jnp.einsum("pg,gfij->pfij", oh_host, pre.R_fej, precision=_HI)
    t_fej_p = jnp.einsum("pg,gfi->pfi", oh_host, pre.t_fej, precision=_HI)
    adj_p = jnp.einsum("pg,gfij->pfij", oh_host, pre.adj_fej, precision=_HI)
    a_cur_p = jnp.einsum("pg,gf->pf", oh_host, pre.alpha_cur, precision=_HI)
    a_fej_p = jnp.einsum("pg,gf->pf", oh_host, pre.alpha_fej, precision=_HI)
    bh_cur = jnp.einsum("pg,g->p", oh_host, pre.b_host_cur, precision=_HI)
    bh_fej = jnp.einsum("pg,g->p", oh_host, pre.b_host_fej, precision=_HI)

    # gather per-point relative transforms / affine for each target slot
    # (indexing [host, target]; python loop over the static F target slots)
    per_f = []
    for f in range(F):
        R_cur = R_cur_p[:, f]                                        # [P, 3, 3]
        t_cur = t_cur_p[:, f]                                        # [P, 3]
        R_fej = R_fej_p[:, f]
        t_fej = t_fej_p[:, f]
        adj = adj_p[:, f]                                            # [P, 6, 6]
        a_cur = a_cur_p[:, f]                                        # [P]
        a_fej = a_fej_p[:, f]
        bt_cur = pre.b_tgt_cur[f]

        # ---- current projection of all 8 pattern points
        Xk = jnp.einsum("pij,pkj->pki", R_cur, xh_cur, precision=_HI) \
            + t_cur[:, None, :] * win.p_idepth[:, None, None]        # [P, 8, 3]
        zk = Xk[..., 2]
        ok_z = zk > 1e-6
        safe_zk = jnp.where(ok_z, zk, 1.0)   # NaN-safe: bad pairs masked below
        uk = fx * Xk[..., 0] / safe_zk + win.c[2]
        vk = fy * Xk[..., 1] / safe_zk + win.c[3]
        uvk = jnp.stack([uk, vk], axis=-1)
        ok_pat = in_bounds(uvk, W_img, H_img, 2.0) & ok_z            # [P, 8]
        uvk = jnp.where(ok_pat[..., None], uvk, 2.0)

        hit = bilinear_packed(packed[f], uvk, 3)                     # [P, 8, 3]
        r_k = hit[..., 0] - bt_cur - a_cur[:, None] * (
            win.p_color - bh_cur[:, None])                           # [P, 8]

        # ---- FEJ central projection for the shared geometric Jacobian
        X0 = jnp.einsum("pij,pj->pi", R_fej, xh_fej_c, precision=_HI) \
            + t_fej * win.p_idepth_zero[:, None]                     # [P, 3]
        z0 = X0[..., 2]
        ok_fej = z0 > 1e-6
        safe_z0 = jnp.where(ok_fej, z0, 1.0)
        drescale = 1.0 / safe_z0
        up0 = X0[..., 0] * drescale
        vp0 = X0[..., 1] * drescale
        new_id0 = win.p_idepth_zero * drescale
        u0_pix = fx0 * up0 + win.c_zero[2]
        v0_pix = fy0 * vp0 + win.c_zero[3]
        ok_fej = ok_fej & in_bounds(
            jnp.stack([u0_pix, v0_pix], axis=-1), W_img, H_img, 2.0)

        Jp_pose = _pose_jacobian(up0, vp0, new_id0, fx0, fy0)        # [P, 2, 6]
        Jp_cam = _cam_jacobian(up0, vp0, drescale, xh_fej_c,
                               R_fej, fx0, fy0, win.c_zero)          # [P, 2, 4]
        Jp_d = jnp.stack(
            [fx0 * drescale * (t_fej[..., 0] - t_fej[..., 2] * up0),
             fy0 * drescale * (t_fej[..., 1] - t_fej[..., 2] * vp0)], axis=-1)  # [P, 2]

        # ---- per-pattern image gradients (current, like the reference)
        g = hit[..., 1:3]                                            # [P, 8, 2]

        Jt_pose = jnp.einsum("pkg,pgj->pkj", g, Jp_pose, precision=_HI)   # [P, 8, 6]
        Jh_pose = -jnp.einsum("pkj,pji->pki", Jt_pose, adj, precision=_HI)
        J_cam = jnp.einsum("pkg,pgj->pkj", g, Jp_cam, precision=_HI)      # [P, 8, 4]
        J_d = jnp.einsum("pkg,pg->pk", g, Jp_d, precision=_HI)            # [P, 8]

        # affine Jacobians at FEJ (dr/da_t, dr/db_t, dr/da_h, dr/db_h)
        col0 = win.p_color - bh_fej[:, None]                         # [P, 8]
        Ja_t = -a_fej[:, None] * col0
        Jb_t = -jnp.ones_like(col0)
        Ja_h = a_fej[:, None] * col0
        Jb_h = a_fej[:, None] * jnp.ones_like(col0)

        target8 = jnp.concatenate([Jt_pose, Ja_t[..., None], Jb_t[..., None]], axis=-1)
        host8 = jnp.concatenate([Jh_pose, Ja_h[..., None], Jb_h[..., None]], axis=-1)

        # ---- validity & weights
        valid_k = (
            ok_pat & ok_fej[:, None]
            & win.res_mask[:, f][:, None] & win.p_valid[:, None]
            & win.frame_valid[f]
        )
        w_tgt = jnp.sqrt(outlier_sum / (outlier_sum + jnp.sum(g * g, axis=-1)))
        w_stat = 0.5 * (w_tgt + win.p_weight)                        # [P, 8]
        abs_r = jnp.abs(r_k)
        hw = jnp.where(abs_r < huber_th, 1.0, huber_th / jnp.maximum(abs_r, 1e-12))
        omega = jnp.where(valid_k, w_stat * w_stat * hw, 0.0)        # [P, 8]
        e_k = omega * r_k * r_k * (2.0 - hw)                         # reference energy

        per_f.append(dict(
            target8=target8, host8=host8, J_cam=J_cam, J_d=J_d,
            r=r_k, omega=omega, e=e_k, valid=valid_k,
        ))

    # stack over target slots -> [P, F, 8, ...]
    target8 = jnp.stack([d["target8"] for d in per_f], axis=1)
    host8 = jnp.stack([d["host8"] for d in per_f], axis=1)
    J_cam = jnp.stack([d["J_cam"] for d in per_f], axis=1)
    J_d = jnp.stack([d["J_d"] for d in per_f], axis=1)
    r = jnp.stack([d["r"] for d in per_f], axis=1)
    omega = jnp.stack([d["omega"] for d in per_f], axis=1)
    e_k = jnp.stack([d["e"] for d in per_f], axis=1)
    valid_k = jnp.stack([d["valid"] for d in per_f], axis=1)

    # residual used for the gradient: current (active) or FEJ-transported.
    # J·Δ is evaluated factor-wise — rows have only host-8/target-8/cam-4
    # support, so the [P, F, 8, D] dense row matrix is never built.
    if mode == "fej":
        delta = state_delta(win)                                     # [D]
        dF = delta[:8 * F].reshape(F, 8)
        dC = delta[8 * F:]
        jdelta = (
            jnp.einsum("pfka,fa->pfk", target8, dF, precision=_HI)
            + jnp.einsum("pfka,pa->pfk", host8, dF[host], precision=_HI)
            + jnp.einsum("pfka,a->pfk", J_cam, dC, precision=_HI)
            + J_d * (win.p_idepth - win.p_idepth_zero)[:, None, None]
        )
        r_used = r - jdelta
    else:
        r_used = r

    # ---- block-structured H = JᵀΩJ (DSO's AccumulatedTopHessian block
    # layout as einsums: the [P, F, 8, D] row matrix would be 8F/20 ≈ 3.4x
    # the HBM traffic of the compact factors — assemble per-block instead)
    t8w = omega[..., None] * target8                                 # [P,F,8,8]
    h8w = omega[..., None] * host8
    c4w = omega[..., None] * J_cam

    A_tt = jnp.einsum("pfka,pfkb->fab", t8w, target8, precision=_HI)   # [F,8,8]
    m_hh = jnp.einsum("pfka,pfkb->pab", h8w, host8, precision=_HI)     # [P,8,8]
    A_hh = jnp.einsum("pab,pg->gab", m_hh, oh_host, precision=_HI)     # [F,8,8]
    x_ht = jnp.einsum("pfka,pfkb->pfab", h8w, target8, precision=_HI)  # [P,F,8,8]
    A_ht = jnp.einsum("pfab,pg->gfab", x_ht, oh_host, precision=_HI)   # [G,F,8,8]
    A_cc = jnp.einsum("pfka,pfkb->ab", c4w, J_cam, precision=_HI)      # [4,4]
    A_tc = jnp.einsum("pfka,pfkb->fab", t8w, J_cam, precision=_HI)     # [F,8,4]
    m_hc = jnp.einsum("pfka,pfkb->pab", h8w, J_cam, precision=_HI)     # [P,8,4]
    A_hc = jnp.einsum("pab,pg->gab", m_hc, oh_host, precision=_HI)     # [F,8,4]

    eye_f = jnp.eye(F, dtype=r.dtype)
    blocks = (jnp.einsum("fab,fg->fgab", A_tt + A_hh, eye_f,
                         precision=_HI)                            # diagonal
              + A_ht                                                   # (host g, target f)
              + jnp.transpose(A_ht, (1, 0, 3, 2)))                     # symmetric
    Hff = jnp.transpose(blocks, (0, 2, 1, 3)).reshape(8 * F, 8 * F)
    A_fc = (A_tc + A_hc).reshape(8 * F, 4)
    H = jnp.concatenate([
        jnp.concatenate([Hff, A_fc], axis=1),
        jnp.concatenate([A_fc.T, A_cc], axis=1)], axis=0)            # [D, D]

    wr = omega * r_used
    b_t = jnp.einsum("pfka,pfk->fa", target8, wr, precision=_HI)     # [F,8]
    b_hp = jnp.einsum("pfka,pfk->pa", host8, wr, precision=_HI)      # [P,8]
    b_h = jnp.einsum("pa,pg->ga", b_hp, oh_host, precision=_HI)      # [F,8]
    b_c = jnp.einsum("pfka,pfk->a", J_cam, wr, precision=_HI)        # [4]
    b = jnp.concatenate([(b_t + b_h).reshape(8 * F), b_c])

    wJd = omega * J_d
    hx_t = jnp.einsum("pfka,pfk->pfa", target8, wJd, precision=_HI)  # [P,F,8]
    hx_h = jnp.einsum("pfka,pfk->pa", host8, wJd, precision=_HI)     # [P,8]
    hx_f = hx_t + jnp.einsum("pa,pg->pga", hx_h, oh_host, precision=_HI)
    hx_c = jnp.einsum("pfka,pfk->pa", J_cam, wJd, precision=_HI)     # [P,4]
    H_xd = jnp.concatenate([hx_f.reshape(P, 8 * F), hx_c], axis=1)   # [P, D]
    H_dd = jnp.sum(wJd * J_d, axis=(1, 2))                           # [P]
    b_d = jnp.sum(wJd * r_used, axis=(1, 2))                         # [P]

    e_pair = jnp.sum(e_k, axis=-1)                                   # [P, F]
    valid_pair = jnp.any(valid_k, axis=-1)
    requested = win.res_mask & win.p_valid[:, None] & win.frame_valid[None, :]
    oob_pair = requested & ~valid_pair

    return BASystem(
        H=H, b=b, H_xd=H_xd, H_dd=H_dd, b_d=b_d,
        energy=jnp.sum(e_k), e_pair=e_pair,
        valid_pair=valid_pair, oob_pair=oob_pair,
        num_res=jnp.sum(valid_k),
    )


@functools.partial(jax.jit, static_argnames=("huber_th", "outlier_sum"))
def energy_only(win: Window, huber_th: float = 9.0, outlier_sum: float = 2500.0):
    """Total Huber energy at the current state (no Jacobians) — the
    accept/reject evaluation of a trial GN step (reference:
    FullSystem::linearizeAll energy accumulation)."""
    F = win.num_frames
    pat = jnp.asarray(PATTERN_OFFSETS)
    pre = precompute_pairs(win)
    fx, fy = win.c[0], win.c[1]
    H_img, W_img = win.images.shape[1], win.images.shape[2]
    uv_pat = win.p_uv[:, None, :] + pat[None, :, :]
    xh_cur = _normalized_dirs(uv_pat, win.c)
    host = win.p_host
    packed = jax.vmap(pack_corners)(win.images)
    oh_host = jax.nn.one_hot(host, F, dtype=win.p_uv.dtype)
    R_cur_p = jnp.einsum("pg,gfij->pfij", oh_host, pre.R_cur, precision=_HI)
    t_cur_p = jnp.einsum("pg,gfi->pfi", oh_host, pre.t_cur, precision=_HI)
    a_cur_p = jnp.einsum("pg,gf->pf", oh_host, pre.alpha_cur, precision=_HI)
    bh_cur = jnp.einsum("pg,g->p", oh_host, pre.b_host_cur, precision=_HI)
    total = 0.0
    count = 0
    for f in range(F):
        R_cur = R_cur_p[:, f]
        t_cur = t_cur_p[:, f]
        a_cur = a_cur_p[:, f]
        bt_cur = pre.b_tgt_cur[f]
        Xk = jnp.einsum("pij,pkj->pki", R_cur, xh_cur, precision=_HI) \
            + t_cur[:, None, :] * win.p_idepth[:, None, None]
        zk = Xk[..., 2]
        ok_z = zk > 1e-6
        safe_zk = jnp.where(ok_z, zk, 1.0)
        uk = fx * Xk[..., 0] / safe_zk + win.c[2]
        vk = fy * Xk[..., 1] / safe_zk + win.c[3]
        uvk = jnp.stack([uk, vk], axis=-1)
        ok = in_bounds(uvk, W_img, H_img, 2.0) & ok_z \
            & win.res_mask[:, f][:, None] & win.p_valid[:, None] & win.frame_valid[f]
        uvk = jnp.where(ok[..., None], uvk, 2.0)
        hit = bilinear_packed(packed[f], uvk, 3)
        r_k = hit[..., 0] - bt_cur - a_cur[:, None] * (win.p_color - bh_cur[:, None])
        w_tgt = jnp.sqrt(outlier_sum / (outlier_sum + jnp.sum(hit[..., 1:3] ** 2, axis=-1)))
        w_stat = 0.5 * (w_tgt + win.p_weight)
        abs_r = jnp.abs(r_k)
        hw = jnp.where(abs_r < huber_th, 1.0, huber_th / jnp.maximum(abs_r, 1e-12))
        omega = jnp.where(ok, w_stat * w_stat * hw, 0.0)
        total = total + jnp.sum(omega * r_k * r_k * (2.0 - hw))
        count = count + jnp.sum(ok)
    return total, count
