"""Sim(3) loop-constraint estimation: batched RANSAC + GN refinement.

JAX redesign of the reference's loop-geometry pipeline
(reference: n-lalanne/LDSO src/frontend/LoopClosing.cc —
cv::solvePnPRansac for an SE3 initialization followed by a g2o Sim3
refinement with inverse-depth-weighted reprojection edges): because both
keyframes carry depth for their matched features, the minimal solver
here is the 3-point closed-form Sim(3) (Umeyama/Horn on 3D-3D
correspondences — the same choice ORB-SLAM's Sim3Solver makes), which
vectorizes perfectly: all RANSAC hypotheses are solved in ONE batched
program (no sequential hypothesis loop), scored by symmetric
reprojection, and the winner is polished by a Huber-weighted
Gauss-Newton on the 7-dof tangent with jacfwd-derived Jacobians.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ldso_tpu.math import lie

_HI = jax.lax.Precision.HIGHEST


class Sim3Result(NamedTuple):
    S_ab: jnp.ndarray       # [4, 4] Sim3: a_cam ← b_cam
    n_inliers: jnp.ndarray  # i32
    inliers: jnp.ndarray    # bool [N]


def umeyama_sim3(A, B, w=None):
    """Closed-form Sim3 (a ← b) from 3D-3D pairs: A ≈ S·B.

    A, B: [..., N, 3]; optional weights [..., N]. Batched over leading
    axes (the RANSAC hypothesis axis)."""
    if w is None:
        w = jnp.ones(A.shape[:-1], A.dtype)
    wn = w / jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), 1e-12)
    mu_a = jnp.sum(A * wn[..., None], axis=-2)
    mu_b = jnp.sum(B * wn[..., None], axis=-2)
    Ac = A - mu_a[..., None, :]
    Bc = B - mu_b[..., None, :]
    cov = jnp.einsum("...ni,...n,...nj->...ij", Ac, wn, Bc, precision=_HI)
    U, D, Vt = jnp.linalg.svd(cov)
    det = jnp.linalg.det(jnp.einsum("...ij,...jk->...ik", U, Vt,
                                    precision=_HI))
    S_fix = jnp.ones(A.shape[:-2] + (3,), A.dtype).at[..., 2].set(jnp.sign(det))
    R = jnp.einsum("...ij,...j,...jk->...ik", U, S_fix, Vt, precision=_HI)
    var_b = jnp.sum(wn * jnp.sum(Bc * Bc, axis=-1), axis=-1)
    s = jnp.sum(D * S_fix, axis=-1) / jnp.maximum(var_b, 1e-12)
    t = mu_a - s[..., None] * jnp.einsum("...ij,...j->...i", R, mu_b,
                                         precision=_HI)
    return lie.sim3(s, R, t)


def _project(X, intr):
    z = jnp.maximum(X[..., 2], 1e-6)
    return jnp.stack([intr[0] * X[..., 0] / z + intr[2],
                      intr[1] * X[..., 1] / z + intr[3]], axis=-1)


def _apply(S, X):
    return jnp.einsum("...ij,...nj->...ni", S[..., :3, :3], X,
                      precision=_HI) \
        + S[..., None, :3, 3]


def symmetric_inliers(S_ab, X_a, uv_a, X_b, uv_b, valid, intr, th: float):
    """Inlier mask under symmetric reprojection: b's points through S into
    cam a, and a's points through S⁻¹ into cam b."""
    S_ba = lie.sim3_inverse(S_ab)
    e_a = jnp.linalg.norm(_project(_apply(S_ab, X_b), intr) - uv_a, axis=-1)
    e_b = jnp.linalg.norm(_project(_apply(S_ba, X_a), intr) - uv_b, axis=-1)
    return valid & (e_a < th) & (e_b < th)


@functools.partial(jax.jit, static_argnames=("n_hyps",))
def ransac_sim3(X_a, uv_a, X_b, uv_b, valid, intr, key,
                n_hyps: int = 256, threshold: float = 5.0) -> Sim3Result:
    """All hypotheses in one batch (reference ladder: solvePnPRansac's
    sequential trials → one [H, 3] gather + batched Umeyama here)."""
    N = X_a.shape[0]
    # sample triplets proportional to validity
    p = valid.astype(jnp.float32)
    p = p / jnp.maximum(p.sum(), 1e-9)
    idx = jax.random.choice(key, N, shape=(n_hyps, 3), replace=True, p=p)
    A = X_a[idx]                                                  # [H, 3, 3]
    B = X_b[idx]
    S = umeyama_sim3(A, B)                                        # [H, 4, 4]
    # degenerate-sample + scale sanity gate
    s = lie.sim3_scale(S)
    ok_h = jnp.isfinite(s) & (s > 0.1) & (s < 10.0)

    inl = jax.vmap(
        lambda Sh: symmetric_inliers(Sh, X_a, uv_a, X_b, uv_b, valid,
                                     intr, threshold))(S)         # [H, N]
    counts = jnp.where(ok_h, jnp.sum(inl, axis=-1), -1)
    best = jnp.argmax(counts)
    S_best = S[best]
    inliers = inl[best]
    # re-fit on all inliers (weighted Umeyama) for a better starting point
    S_fit = umeyama_sim3(X_a, X_b, w=inliers.astype(X_a.dtype))
    inl2 = symmetric_inliers(S_fit, X_a, uv_a, X_b, uv_b, valid, intr,
                             threshold)
    take_fit = jnp.sum(inl2) >= jnp.sum(inliers)
    S_out = jnp.where(take_fit, S_fit, S_best)
    inl_out = jnp.where(take_fit, inl2, inliers)
    return Sim3Result(S_ab=S_out, n_inliers=jnp.sum(inl_out), inliers=inl_out)


def _dlt_pose(X, uv, intr):
    """Batched DLT camera pose from ≥6 2D-3D pairs: X [..., K, 3] (world),
    uv [..., K, 2] (pixels) → [..., 4, 4] with scaled rotation (Sim3-like;
    scale absorbs the DLT's projective ambiguity residue).

    Standard two-rows-per-point nullspace solve (the vectorizable stand-in
    for the reference's cv::solvePnPRansac minimal solver)."""
    x = (uv[..., 0] - intr[2]) / intr[0]
    y = (uv[..., 1] - intr[3]) / intr[1]
    K = X.shape[-2]
    zeros = jnp.zeros_like(X)
    ones = jnp.ones(X.shape[:-1], X.dtype)
    Xh = jnp.concatenate([X, ones[..., None]], axis=-1)            # [..., K, 4]
    z4 = jnp.zeros_like(Xh)
    row_u = jnp.concatenate([Xh, z4, -x[..., None] * Xh], axis=-1)  # [..., K, 12]
    row_v = jnp.concatenate([z4, Xh, -y[..., None] * Xh], axis=-1)
    A = jnp.concatenate([row_u, row_v], axis=-2)                    # [..., 2K, 12]
    # nullspace via eigh of AᵀA (batched)
    AtA = jnp.einsum("...ki,...kj->...ij", A, A, precision=_HI)
    w, V = jnp.linalg.eigh(AtA)
    p = V[..., :, 0]                                                # [..., 12]
    P = p.reshape(*p.shape[:-1], 3, 4)
    M = P[..., :3]
    # sign: points must land in front (positive depth for the centroid)
    Xc = jnp.mean(X, axis=-2)
    depth = jnp.einsum("...j,...j->...", M[..., 2, :], Xc,
                       precision=_HI) + P[..., 2, 3]
    sgn = jnp.where(depth < 0, -1.0, 1.0)
    P = P * sgn[..., None, None]
    M = P[..., :3]
    # orthogonalize: M = s·R with R from SVD, s = mean singular value
    U, D, Vt = jnp.linalg.svd(M)
    det = jnp.linalg.det(jnp.einsum("...ij,...jk->...ik", U, Vt,
                                    precision=_HI))
    fix = jnp.ones(M.shape[:-2] + (3,), M.dtype).at[..., 2].set(jnp.sign(det))
    R = jnp.einsum("...ij,...j,...jk->...ik", U, fix, Vt, precision=_HI)
    s = jnp.mean(D * fix, axis=-1)
    t = P[..., 3] / jnp.maximum(s[..., None], 1e-12)
    out = jnp.zeros(M.shape[:-2] + (4, 4), M.dtype)
    out = out.at[..., :3, :3].set(R)
    out = out.at[..., :3, 3].set(t)
    out = out.at[..., 3, 3].set(1.0)
    return out


@functools.partial(jax.jit, static_argnames=("n_hyps",))
def ransac_pnp(X, uv, valid, intr, key, n_hyps: int = 256,
               threshold: float = 8.0) -> Sim3Result:
    """Batched DLT-PnP RANSAC: pose of the camera observing known 3D
    points X at pixels uv. Returns T (SE3 in a Sim3 container) mapping
    X's frame into the observing camera."""
    N = X.shape[0]
    p = valid.astype(jnp.float32)
    p = p / jnp.maximum(p.sum(), 1e-9)
    idx = jax.random.choice(key, N, shape=(n_hyps, 6), replace=True, p=p)
    T = _dlt_pose(X[idx], uv[idx], intr)                           # [H, 4, 4]
    proj = jax.vmap(lambda Th: _project(_apply(Th, X), intr))(T)   # [H, N, 2]
    err = jnp.linalg.norm(proj - uv[None], axis=-1)
    depth_ok = jax.vmap(lambda Th: _apply(Th, X)[..., 2] > 1e-3)(T)
    inl = valid[None] & (err < threshold) & depth_ok
    counts = jnp.sum(inl, axis=-1)
    best = jnp.argmax(counts)
    return Sim3Result(S_ab=T[best], n_inliers=counts[best], inliers=inl[best])


@functools.partial(jax.jit, static_argnames=("iters",))
def refine_pnp(S0, X, uv, inliers, valid, intr, iters: int = 10,
               huber_px: float = 3.0) -> Sim3Result:
    """GN on the 7-dof tangent for single-direction reprojection
    (2D-3D); scale is observable through projected depth."""

    def residuals(eps, S):
        Se = lie.sim3_mul(lie.sim3_exp(eps), S)
        return (_project(_apply(Se, X), intr) - uv).reshape(-1)

    w_full = jnp.repeat(inliers.astype(X.dtype), 2)

    def step(S, _):
        eps0 = jnp.zeros(7, X.dtype)
        r = residuals(eps0, S)
        J = jax.jacfwd(residuals)(eps0, S)
        hw = jnp.where(jnp.abs(r) < huber_px, 1.0,
                       huber_px / jnp.maximum(jnp.abs(r), 1e-9))
        om = w_full * hw
        H = jnp.einsum("ri,r,rj->ij", J, om, J, precision=_HI)
        b = jnp.einsum("ri,r->i", J, om * r, precision=_HI)
        H = H + 1e-6 * jnp.eye(7, dtype=H.dtype) * jnp.maximum(jnp.trace(H), 1.0)
        return lie.sim3_mul(lie.sim3_exp(-jnp.linalg.solve(H, b)), S), None

    S, _ = jax.lax.scan(step, S0, None, length=iters)
    err = jnp.linalg.norm(_project(_apply(S, X), intr) - uv, axis=-1)
    inl = valid & (err < 2.0 * huber_px) & (_apply(S, X)[..., 2] > 1e-3)
    return Sim3Result(S_ab=S, n_inliers=jnp.sum(inl), inliers=inl)


@functools.partial(jax.jit, static_argnames=("iters",))
def refine_sim3(S0, X_a, uv_a, X_b, uv_b, inliers, valid, intr,
                iters: int = 10, huber_px: float = 3.0) -> Sim3Result:
    """Huber GN on the 7-dof tangent, symmetric reprojection residuals
    (reference: the g2o Sim3 vertex + EdgeSim3ProjectXYZ refinement)."""

    def residuals(eps, S):
        Se = lie.sim3_mul(lie.sim3_exp(eps), S)
        r_a = _project(_apply(Se, X_b), intr) - uv_a              # [N, 2]
        r_b = _project(_apply(lie.sim3_inverse(Se), X_a), intr) - uv_b
        return jnp.concatenate([r_a, r_b], axis=0).reshape(-1)    # [4N]

    w_pt = inliers.astype(X_a.dtype)
    w_full = jnp.tile(jnp.repeat(w_pt, 2), 2)                     # [4N]

    def step(S, _):
        eps0 = jnp.zeros(7, X_a.dtype)
        r = residuals(eps0, S)
        J = jax.jacfwd(residuals)(eps0, S)                        # [4N, 7]
        hw = jnp.where(jnp.abs(r) < huber_px, 1.0,
                       huber_px / jnp.maximum(jnp.abs(r), 1e-9))
        om = w_full * hw
        H = jnp.einsum("ri,r,rj->ij", J, om, J, precision=_HI)
        b = jnp.einsum("ri,r->i", J, om * r, precision=_HI)
        H = H + 1e-6 * jnp.eye(7, dtype=H.dtype) * jnp.maximum(jnp.trace(H), 1.0)
        eps = -jnp.linalg.solve(H, b)
        return lie.sim3_mul(lie.sim3_exp(eps), S), None

    S, _ = jax.lax.scan(step, S0, None, length=iters)
    inl = symmetric_inliers(S, X_a, uv_a, X_b, uv_b, valid, intr,
                            huber_px * 2.0)
    return Sim3Result(S_ab=S, n_inliers=jnp.sum(inl), inliers=inl)
