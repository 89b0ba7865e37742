"""Marginalization: folding dying points and frames into the dense prior.

JAX redesign of the reference's consistency-critical path
(reference: n-lalanne/LDSO ``EnergyFunctional::marginalizePointsF`` and
``EnergyFunctional::marginalizeFrame``, SURVEY.md §3.4):

  * points flagged for marginalization contribute their FEJ-linearized
    residuals (Jacobians at the linearization point, residuals
    transported to it first-order — EFResidual::fixLinearization's
    res_toZeroF) to the prior, with their inverse depth Schur-eliminated
    per point. The heavy evaluation runs on device (mode="fej" assembly
    restricted to the dying points); the fold into HM/bM happens here.
  * frames leaving the window have their 8-block Schur-complemented out
    of HM/bM — done on HOST in float64 with sqrt-diagonal conditioning
    (the reference keeps HM in double for the same reason; SURVEY §7.2
    risk #1).

The prior lives in delta-from-FEJ coordinates: energy(Δ) = ½ΔᵀHMΔ + bMᵀΔ
with Δ = state − state_zero stacked (core/window.py:state_delta).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np

from ldso_tpu.config import LdsoConfig
from ldso_tpu.core.window import Window
from ldso_tpu.ba.residuals import assemble

# reference: setting_margWeightFac = 0.5·0.5 — down-weights marginalized
# terms to account for linearization error
MARG_WEIGHT_FAC = 0.25


def points_fold_start(win: Window, marg_mask: np.ndarray, cfg: LdsoConfig):
    """Dispatch the FEJ assembly of dying points and START its
    device→host copies; returns an opaque handle for
    :func:`points_fold_apply`.

    Split from the fold so the conductor can DEFER the f64 prior update
    to the next prior use (the next keyframe's BA): a blocking
    device_get here sat behind the whole pipelined device queue and
    measured 70 ms - 2.5 s per marginalizing keyframe."""
    win_m = win._replace(p_valid=win.p_valid & jnp.asarray(marg_mask))
    sys = assemble(
        win_m, huber_th=cfg.ba.huber_th,
        outlier_sum=cfg.ba.outlier_th_sum_component, mode="fej",
    )
    handle = (sys.H, sys.b, sys.H_xd, sys.H_dd, sys.b_d,
              np.asarray(marg_mask))
    try:
        for a in handle[:5]:
            a.copy_to_host_async()
    except (AttributeError, NotImplementedError):
        pass
    return handle


def points_fold_apply(handle, HM: np.ndarray,
                      bM: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Complete a deferred point fold: pull the (long since transferred)
    FEJ blocks and fold them into the f64 prior.

    Equivalent of accumulateAF/SC in mode=2 (AccumulatedTopHessian
    addPoint<2>): H_prior += Jᵀ Ω J − Schur(idepth), b_prior += Jᵀ Ω r₀."""
    import jax

    marg_mask = handle[5]
    H, b, Hxd, Hdd, bd = (
        np.asarray(a, dtype=np.float64)
        for a in jax.device_get(handle[:5]))

    active = marg_mask & (Hdd > 1e-8)
    inv_dd = np.where(active, 1.0 / np.maximum(Hdd, 1e-8), 0.0)
    H_sc = Hxd.T @ (Hxd * inv_dd[:, None])
    b_sc = Hxd.T @ (bd * inv_dd)

    HM = HM + MARG_WEIGHT_FAC * (H - H_sc)
    bM = bM + MARG_WEIGHT_FAC * (b - b_sc)
    return HM, bM


def marginalize_points(
    win: Window,
    marg_mask: np.ndarray,       # [P] points to fold into the prior
    HM: np.ndarray,              # [D, D] f64, updated in place semantics (returned)
    bM: np.ndarray,              # [D] f64
    cfg: LdsoConfig,
) -> Tuple[np.ndarray, np.ndarray]:
    """Synchronous fold of dying points into HM/bM (start + apply;
    used by tests and the initializer path — the KF path defers)."""
    marg_mask = np.asarray(marg_mask)
    if not marg_mask.any():
        return HM, bM
    return points_fold_apply(points_fold_start(win, marg_mask, cfg), HM, bM)


def marginalize_frame(
    slot: int,
    HM: np.ndarray,
    bM: np.ndarray,
    frame_prior_diag: np.ndarray | None = None,   # [8] extra prior on the dying block
    frame_prior_delta: np.ndarray | None = None,  # [8] its delta
) -> Tuple[np.ndarray, np.ndarray]:
    """Schur-complement a frame's 8-block out of the prior (host, f64).

    Mirrors EnergyFunctional::marginalizeFrame: add the frame's own prior
    first, condition with sqrt-diagonal scaling, pseudo-invert the dying
    block, eliminate, and zero the freed slot."""
    D = HM.shape[0]
    idx_v = np.arange(8 * slot, 8 * slot + 8)
    idx_k = np.setdiff1d(np.arange(D), idx_v)

    HM = HM.copy()
    bM = bM.copy()
    if frame_prior_diag is not None:
        HM[idx_v, idx_v] += frame_prior_diag
        bM[idx_v] += frame_prior_diag * (
            frame_prior_delta if frame_prior_delta is not None else 0.0
        )

    # sqrt-diagonal conditioning (reference: SVec scaling in marginalizeFrame)
    s = np.sqrt(np.abs(np.diag(HM)) + 10.0)
    s_inv = 1.0 / s
    Hs = HM * s_inv[:, None] * s_inv[None, :]
    bs = bM * s_inv

    Hvv = Hs[np.ix_(idx_v, idx_v)]
    # pseudo-inverse: the dying block can be rank-deficient (e.g. a frame
    # whose every residual was dropped)
    Hvv_inv = np.linalg.pinv(0.5 * (Hvv + Hvv.T), rcond=1e-8)
    Hkv = Hs[np.ix_(idx_k, idx_v)]
    Hs_new = Hs[np.ix_(idx_k, idx_k)] - Hkv @ Hvv_inv @ Hkv.T
    bs_new = bs[idx_k] - Hkv @ (Hvv_inv @ bs[idx_v])

    HM_out = np.zeros_like(HM)
    bM_out = np.zeros_like(bM)
    HM_out[np.ix_(idx_k, idx_k)] = 0.5 * (Hs_new + Hs_new.T) * np.outer(s[idx_k], s[idx_k])
    bM_out[idx_k] = bs_new * s[idx_k]
    return HM_out, bM_out


def empty_prior(D: int) -> Tuple[np.ndarray, np.ndarray]:
    return np.zeros((D, D), dtype=np.float64), np.zeros(D, dtype=np.float64)
