"""Batched Lie-group operations: SO(3), SE(3), Sim(3).

JAX replacement for the reference's Sophus dependency
(reference: n-lalanne/LDSO include/NumTypes.h — ``SE3 = Sophus::SE3d``,
``Sim3 = Sophus::Sim3d``). Everything here is pure ``jnp``, shape-batched
(leading dims broadcast), differentiable, and dtype-polymorphic (f32 on
device, f64 for host-side precision-critical paths).

Conventions:
  * group elements are ``[..., 4, 4]`` homogeneous matrices. For Sim(3)
    the top-left block is ``s·R``.
  * tangent vectors follow the Sophus ordering ``[rho, phi]`` for SE(3)
    (translation part first) and ``[rho, phi, sigma]`` for Sim(3).
  * small-angle branches use Taylor expansions selected with
    ``jnp.where`` on a safe (non-NaN-producing) formulation, so both
    values and gradients are finite everywhere.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

_EPS = 1e-8

# Small (3x3 / 4x4) matrix algebra must not lose precision to
# reduced-precision f32 products (TF32 on a GPU) — pin HIGHEST here.
_mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
_einsum = functools.partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)


def solve33(A, b):
    """Batched 3x3 solve via Cramer's rule (elementwise — no LU custom call).

    A: [..., 3, 3], b: [..., 3]. Intended for well-conditioned matrices
    (left Jacobians V, W are near identity for moderate tangents).
    """
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c10 + a02 * c20
    inv_det = 1.0 / det
    x0 = (c00 * b[..., 0] + c01 * b[..., 1] + c02 * b[..., 2]) * inv_det
    x1 = (c10 * b[..., 0] + c11 * b[..., 1] + c12 * b[..., 2]) * inv_det
    x2 = (c20 * b[..., 0] + c21 * b[..., 1] + c22 * b[..., 2]) * inv_det
    return jnp.stack([x0, x1, x2], axis=-1)


def _where_taylor(cond, taylor, general):
    return jnp.where(cond, taylor, general)


# ---------------------------------------------------------------------------
# so(3)
# ---------------------------------------------------------------------------


def hat(phi):
    """[..., 3] -> [..., 3, 3] skew-symmetric matrix."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([zero, -z, y], axis=-1),
            jnp.stack([z, zero, -x], axis=-1),
            jnp.stack([-y, x, zero], axis=-1),
        ],
        axis=-2,
    )


def vee(M):
    """[..., 3, 3] skew -> [..., 3]."""
    return jnp.stack([M[..., 2, 1], M[..., 0, 2], M[..., 1, 0]], axis=-1)


def _theta_sq(phi):
    return jnp.sum(phi * phi, axis=-1)


def _sinc_coeffs(theta_sq):
    """Return (A, B) with A = sin(t)/t, B = (1-cos(t))/t^2, Taylor-safe.

    The general branch is evaluated on a "safe" theta (1.0 where the
    Taylor branch is selected) so gradients through jnp.where stay finite.
    """
    small = theta_sq < _EPS
    safe_tsq = jnp.where(small, 1.0, theta_sq)
    theta = jnp.sqrt(safe_tsq)
    a = _where_taylor(small, 1.0 - theta_sq / 6.0, jnp.sin(theta) / theta)
    b = _where_taylor(small, 0.5 - theta_sq / 24.0, (1.0 - jnp.cos(theta)) / safe_tsq)
    return a, b


def so3_exp(phi):
    """Rodrigues: [..., 3] -> [..., 3, 3]."""
    tsq = _theta_sq(phi)
    a, b = _sinc_coeffs(tsq)
    K = hat(phi)
    K2 = _mm(K, K)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * K2


def so3_log(R):
    """[..., 3, 3] -> [..., 3]; uniformly accurate via the quaternion path.

    q = (xyz, w) with w >= 0, theta = 2·atan2(|xyz|, w), phi = theta·xyz/|xyz|.
    atan2 is well-conditioned at both theta -> 0 and theta -> pi.
    """
    q = matrix_to_quat(R)
    q = q * jnp.where(q[..., 3:4] < 0, -1.0, 1.0)  # angle in [0, pi]
    xyz, w = q[..., :3], q[..., 3]
    # AD-safe norm: sum-of-squares first, sqrt only of a safe value —
    # jnp.linalg.norm has a NaN gradient at 0, and identity rotations
    # (straight trajectories!) hit exactly 0 (the NaN would silently
    # zero out pose-graph Jacobians via jacfwd)
    nsq = jnp.sum(xyz * xyz, axis=-1)
    small = nsq < 1e-16
    n = jnp.sqrt(jnp.where(small, 1.0, nsq))
    # phi = 2·atan2(n, w)/n · xyz ; small-n limit: 2/w·(1 - n²/(3w²)) · xyz
    scale = jnp.where(
        small,
        2.0 / jnp.maximum(w, 1e-12) * (1.0 - nsq / (3.0 * jnp.maximum(w * w, 1e-12))),
        2.0 * jnp.arctan2(n, w) / n,
    )
    return scale[..., None] * xyz


def so3_left_jacobian(phi):
    """V(phi): [..., 3] -> [..., 3, 3] with se3_exp translation t = V·rho."""
    tsq = _theta_sq(phi)
    small = tsq < _EPS
    safe_tsq = jnp.where(small, 1.0, tsq)
    theta = jnp.sqrt(safe_tsq)
    # B = (1-cos)/t^2 ; C = (t - sin)/t^3
    b = _where_taylor(small, 0.5 - tsq / 24.0, (1.0 - jnp.cos(theta)) / safe_tsq)
    c = _where_taylor(
        small, 1.0 / 6.0 - tsq / 120.0, (theta - jnp.sin(theta)) / (safe_tsq * theta)
    )
    K = hat(phi)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    return eye + b[..., None, None] * K + c[..., None, None] * _mm(K, K)


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------


def se3(R, t):
    """Assemble [..., 4, 4] from rotation [..., 3, 3] and translation [..., 3]."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = jnp.broadcast_to(R, batch + (3, 3))
    t = jnp.broadcast_to(t, batch + (3,))
    top = jnp.concatenate([R, t[..., :, None]], axis=-1)
    bottom = jnp.zeros(batch + (1, 4), dtype=R.dtype).at[..., 0, 3].set(1.0)
    return jnp.concatenate([top, bottom], axis=-2)


def se3_identity(batch=(), dtype=jnp.float32):
    return jnp.broadcast_to(jnp.eye(4, dtype=dtype), tuple(batch) + (4, 4))


def rotation(T):
    return T[..., :3, :3]


def translation(T):
    return T[..., :3, 3]


def se3_exp(xi):
    """[..., 6] tangent [rho, phi] -> [..., 4, 4]."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    R = so3_exp(phi)
    V = so3_left_jacobian(phi)
    t = _einsum("...ij,...j->...i", V, rho)
    return se3(R, t)


def se3_log(T):
    """[..., 4, 4] -> [..., 6] tangent [rho, phi]."""
    R = rotation(T)
    t = translation(T)
    phi = so3_log(R)
    V = so3_left_jacobian(phi)
    rho = solve33(V, t)
    return jnp.concatenate([rho, phi], axis=-1)


def se3_inverse(T):
    R = rotation(T)
    t = translation(T)
    Rt = jnp.swapaxes(R, -1, -2)
    return se3(Rt, -_einsum("...ij,...j->...i", Rt, t))


def se3_mul(A, B):
    return _mm(A, B)


def se3_adjoint(T):
    """[..., 4, 4] -> [..., 6, 6]: Adj with tangent order [rho, phi].

    Adj = [[R, hat(t)·R], [0, R]] such that T·exp(xi)·T⁻¹ = exp(Adj·xi).
    """
    R = rotation(T)
    t = translation(T)
    tR = _mm(hat(t), R)
    z = jnp.zeros_like(R)
    top = jnp.concatenate([R, tR], axis=-1)
    bottom = jnp.concatenate([z, R], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


# ---------------------------------------------------------------------------
# Sim(3)
# ---------------------------------------------------------------------------


def sim3(s, R, t):
    """Assemble [..., 4, 4] with top-left s·R."""
    return se3(s[..., None, None] * R, t)


def sim3_scale(T):
    """Recover s from the s·R block (rows of s·R have norm s)."""
    return jnp.linalg.norm(T[..., 0, :3], axis=-1)


def sim3_rotation(T):
    s = sim3_scale(T)
    return T[..., :3, :3] / s[..., None, None]


def _sim3_W(phi, sigma):
    """W(phi, sigma) with sim3_exp translation t = W·rho (Sophus calc_W).

    W = C·I + A·hat(phi) + B·hat(phi)², with smooth small-angle /
    small-scale limits. Verified against expm in tests.
    """
    tsq = _theta_sq(phi)
    s = jnp.exp(sigma)
    sig_small = jnp.abs(sigma) < 1e-5
    th_small = tsq < _EPS

    safe_sigma = jnp.where(sig_small, 1.0, sigma)
    safe_tsq = jnp.where(th_small, 1.0, tsq)
    theta = jnp.sqrt(safe_tsq)  # == safe theta (1.0 where th_small)
    safe_theta = theta

    C = jnp.where(sig_small, 1.0 + sigma / 2.0 + sigma * sigma / 6.0, (s - 1.0) / safe_sigma)

    # four-way branch on (sigma small, theta small)
    sin_t, cos_t = jnp.sin(theta), jnp.cos(theta)
    a_ = s * sin_t
    b_ = s * cos_t
    c_ = safe_tsq + sigma * sigma
    safe_c = jnp.where(c_ < 1e-24, 1.0, c_)

    A_gen = (a_ * sigma + (1.0 - b_) * theta) / (safe_theta * safe_c)
    B_gen = (C - ((b_ - 1.0) * sigma + a_ * theta) / safe_c) / safe_tsq

    A_th_small = jnp.where(
        sig_small,
        0.5 + sigma / 6.0,  # -> 1/2 as sigma->0
        ((sigma - 1.0) * s + 1.0) / (safe_sigma * safe_sigma),
    )
    B_th_small = jnp.where(
        sig_small,
        1.0 / 6.0 + sigma / 24.0,
        ((0.5 * sigma * sigma - sigma + 1.0) * s - 1.0) / (safe_sigma ** 3),
    )
    A_sig_small = (1.0 - cos_t) / safe_tsq
    B_sig_small = (theta - sin_t) / (safe_tsq * safe_theta)

    A = jnp.where(th_small, A_th_small, jnp.where(sig_small, A_sig_small, A_gen))
    B = jnp.where(th_small, B_th_small, jnp.where(sig_small, B_sig_small, B_gen))

    K = hat(phi)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), K.shape)
    return C[..., None, None] * eye + A[..., None, None] * K + B[..., None, None] * _mm(K, K)


def sim3_exp(tau):
    """[..., 7] tangent [rho, phi, sigma] -> [..., 4, 4]."""
    rho, phi, sigma = tau[..., :3], tau[..., 3:6], tau[..., 6]
    R = so3_exp(phi)
    s = jnp.exp(sigma)
    W = _sim3_W(phi, sigma)
    t = _einsum("...ij,...j->...i", W, rho)
    return sim3(s, R, t)


def sim3_log(T):
    """[..., 4, 4] -> [..., 7] tangent [rho, phi, sigma]."""
    s = sim3_scale(T)
    R = T[..., :3, :3] / s[..., None, None]
    t = translation(T)
    sigma = jnp.log(s)
    phi = so3_log(R)
    W = _sim3_W(phi, sigma)
    rho = solve33(W, t)
    return jnp.concatenate([rho, phi, sigma[..., None]], axis=-1)


def sim3_inverse(T):
    s = sim3_scale(T)
    R = T[..., :3, :3] / s[..., None, None]
    t = translation(T)
    Rt = jnp.swapaxes(R, -1, -2)
    s_inv = 1.0 / s
    return sim3(s_inv, Rt, -s_inv[..., None] * _einsum("...ij,...j->...i", Rt, t))


def sim3_mul(A, B):
    return _mm(A, B)


def sim3_adjoint(T):
    """[..., 4, 4] -> [..., 7, 7], tangent order [rho, phi, sigma].

    Adj = [[s·R, hat(t)·R, -t], [0, R, 0], [0, 0, 1]].
    """
    s = sim3_scale(T)
    R = T[..., :3, :3] / s[..., None, None]
    t = translation(T)
    batch = T.shape[:-2]
    A = jnp.zeros(batch + (7, 7), dtype=T.dtype)
    A = A.at[..., :3, :3].set(s[..., None, None] * R)
    A = A.at[..., :3, 3:6].set(_mm(hat(t), R))
    A = A.at[..., :3, 6].set(-t)
    A = A.at[..., 3:6, 3:6].set(R)
    A = A.at[..., 6, 6].set(1.0)
    return A


def se3_to_sim3(T):
    """Embed an SE(3) element as Sim(3) with scale 1 (same matrix)."""
    return T


def sim3_to_se3(T):
    """Project Sim(3) -> SE(3) preserving the transform's POSE.

    For a world-to-cam Sim3 [sR | t] the camera center is
    C = −(1/s)·Rᵀ·t; the SE(3) with the same center and rotation is
    (R, t/s) — keeping t unscaled would displace the camera by the
    factor s (reference analog: Sim3::translation()/scale() composition
    when LDSO converts optimized Sim3 poses for export)."""
    s = sim3_scale(T)
    return se3(T[..., :3, :3] / s[..., None, None],
               translation(T) / s[..., None])


# ---------------------------------------------------------------------------
# Quaternions (for trajectory IO — TUM format uses qx qy qz qw)
# ---------------------------------------------------------------------------


def quat_to_matrix(q):
    """[..., 4] (x, y, z, w) -> [..., 3, 3]."""
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], axis=-1),
            jnp.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], axis=-1),
            jnp.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], axis=-1),
        ],
        axis=-2,
    )


def matrix_to_quat(R):
    """[..., 3, 3] -> [..., 4] (x, y, z, w), branch-free (Shepperd-style)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # four candidate formulations; pick the numerically best per element
    qw = jnp.sqrt(jnp.maximum(1.0 + tr, 1e-12)) / 2.0
    qx = jnp.sqrt(jnp.maximum(1.0 + m00 - m11 - m22, 1e-12)) / 2.0
    qy = jnp.sqrt(jnp.maximum(1.0 - m00 + m11 - m22, 1e-12)) / 2.0
    qz = jnp.sqrt(jnp.maximum(1.0 - m00 - m11 + m22, 1e-12)) / 2.0

    case = jnp.argmax(jnp.stack([qw, qx, qy, qz], axis=-1), axis=-1)

    q_w = jnp.stack([(m21 - m12) / (4 * jnp.maximum(qw, 1e-12)),
                     (m02 - m20) / (4 * jnp.maximum(qw, 1e-12)),
                     (m10 - m01) / (4 * jnp.maximum(qw, 1e-12)), qw], axis=-1)
    q_x = jnp.stack([qx, (m01 + m10) / (4 * jnp.maximum(qx, 1e-12)),
                     (m02 + m20) / (4 * jnp.maximum(qx, 1e-12)),
                     (m21 - m12) / (4 * jnp.maximum(qx, 1e-12))], axis=-1)
    q_y = jnp.stack([(m01 + m10) / (4 * jnp.maximum(qy, 1e-12)), qy,
                     (m12 + m21) / (4 * jnp.maximum(qy, 1e-12)),
                     (m02 - m20) / (4 * jnp.maximum(qy, 1e-12))], axis=-1)
    q_z = jnp.stack([(m02 + m20) / (4 * jnp.maximum(qz, 1e-12)),
                     (m12 + m21) / (4 * jnp.maximum(qz, 1e-12)), qz,
                     (m10 - m01) / (4 * jnp.maximum(qz, 1e-12))], axis=-1)

    q = jnp.select(
        [case[..., None] == 0, case[..., None] == 1, case[..., None] == 2],
        [q_w, q_x, q_y],
        q_z,
    )
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)
