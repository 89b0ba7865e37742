"""Global Sim(3) pose-graph optimization.

JAX redesign of the reference's global map backend
(reference: n-lalanne/LDSO src/Map.cc::OptimizeALLKFs +
include/internal/PR.h VertexSim3/EdgeSim3, built on the bundled g2o
SparseOptimizer/Levenberg): instead of a heap-allocated sparse graph
and a CHOLMOD solve, the whole problem is three flat arrays — Sim3
states [K, 4, 4], an edge list (i, j, S_meas) with static capacity, and
a fixed mask — and each Levenberg iteration is one jitted program:
batched edge residuals e = log(S_meas⁻¹ · S_i · S_j⁻¹), per-edge
Jacobians by forward-mode AD, and a block-Jacobi-preconditioned
conjugate-gradient solve whose matvec is two gathers + two scatter-adds
over the edge list (never materializing the [7K, 7K] Hessian — this is
what scales to thousands of keyframes and shards by KF blocks,
SURVEY.md §5.7/§5.8).

Window-fixing semantics mirror the reference: keyframes inside the
current odometry window (plus the first KF, the gauge) are held fixed so
the pose graph never perturbs the sliding-window odometry mid-flight.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ldso_tpu.math import lie

_HI = jax.lax.Precision.HIGHEST


class PGOResult(NamedTuple):
    S: jnp.ndarray           # [K, 4, 4] optimized Sim3 states
    energy: jnp.ndarray      # scalar final Huber energy
    iterations: jnp.ndarray  # i32


def edge_residual(S_i, S_j, S_meas_inv):
    """e = log(S_meas⁻¹ · S_i · S_j⁻¹) ∈ R⁷ (reference: EdgeSim3 error)."""
    return lie.sim3_log(lie.sim3_mul(S_meas_inv,
                                     lie.sim3_mul(S_i, lie.sim3_inverse(S_j))))


def _edge_system(S, ei, ej, S_meas_inv, w_edge, huber: float):
    """Batched residuals + Jacobians for every edge.

    Returns r [E,7], Ji [E,7,7] (∂e/∂εᵢ), Jj [E,7,7], omega [E]."""
    S_i, S_j = S[ei], S[ej]

    def res(eps_i, eps_j, Si, Sj, Smi):
        return edge_residual(lie.sim3_mul(lie.sim3_exp(eps_i), Si),
                             lie.sim3_mul(lie.sim3_exp(eps_j), Sj), Smi)

    z = jnp.zeros(7, S.dtype)
    r = jax.vmap(lambda Si, Sj, Smi: res(z, z, Si, Sj, Smi))(
        S_i, S_j, S_meas_inv)
    Ji = jax.vmap(lambda Si, Sj, Smi: jax.jacfwd(res, argnums=0)(
        z, z, Si, Sj, Smi))(S_i, S_j, S_meas_inv)
    Jj = jax.vmap(lambda Si, Sj, Smi: jax.jacfwd(res, argnums=1)(
        z, z, Si, Sj, Smi))(S_i, S_j, S_meas_inv)

    rn = jnp.linalg.norm(r, axis=-1)
    hw = jnp.where(rn < huber, 1.0, huber / jnp.maximum(rn, 1e-12))
    omega = w_edge * hw
    return r, Ji, Jj, omega


@functools.partial(jax.jit, static_argnames=("lm_iters", "cg_iters"))
def optimize_pose_graph(
    S_init,                  # [K, 4, 4] Sim3 worldToCam
    ei, ej,                  # i32 [E] edge endpoints (into K)
    S_meas,                  # [E, 4, 4] measured S_i · S_j⁻¹
    w_edge,                  # f32 [E] edge weights (0 = padding slot)
    fixed,                   # bool [K] gauge/window-fixed vertices
    lm_iters: int = 20,
    cg_iters: int = 60,
    huber: float = 0.5,
    lam0: float = 1e-4,
) -> PGOResult:
    K = S_init.shape[0]
    S_meas_inv = lie.sim3_inverse(S_meas)
    free = ~fixed                                                  # [K]

    def energy(S):
        S_i, S_j = S[ei], S[ej]
        r = jax.vmap(edge_residual)(S_i, S_j, S_meas_inv)
        rn = jnp.linalg.norm(r, axis=-1)
        hw = jnp.where(rn < huber, 1.0, huber / jnp.maximum(rn, 1e-12))
        return jnp.sum(w_edge * hw * rn * rn * (2.0 - hw))

    def lm_step(carry, _):
        S, lam, E_prev = carry
        r, Ji, Jj, omega = _edge_system(S, ei, ej, S_meas_inv, w_edge, huber)

        # block-diagonal (Jacobi) preconditioner + damping
        Hii = jnp.einsum("eab,e,eac->ebc", Ji, omega, Ji, precision=_HI)
        Hjj = jnp.einsum("eab,e,eac->ebc", Jj, omega, Jj, precision=_HI)
        diag = jnp.zeros((K, 7, 7), S.dtype).at[ei].add(Hii).at[ej].add(Hjj)
        diag = diag + (lam * jnp.maximum(
            jax.vmap(jnp.trace)(diag)[:, None, None] / 7.0, 1e-6) + 1e-8
        ) * jnp.eye(7, dtype=S.dtype)
        diag_inv = jnp.linalg.inv(diag)

        b = jnp.zeros((K, 7), S.dtype)
        b = b.at[ei].add(jnp.einsum("eab,e,ea->eb", Ji, omega, r, precision=_HI))
        b = b.at[ej].add(jnp.einsum("eab,e,ea->eb", Jj, omega, r, precision=_HI))
        b = jnp.where(free[:, None], b, 0.0)

        def matvec(x):
            """(JᵀΩJ + λD)x via edge gather/scatter — no dense Hessian."""
            u = (jnp.einsum("eab,eb->ea", Ji, x[ei], precision=_HI)
                 + jnp.einsum("eab,eb->ea", Jj, x[ej], precision=_HI))
            u = omega[:, None] * u
            y = jnp.zeros_like(x)
            y = y.at[ei].add(jnp.einsum("eab,ea->eb", Ji, u, precision=_HI))
            y = y.at[ej].add(jnp.einsum("eab,ea->eb", Jj, u, precision=_HI))
            # same damping as the preconditioner's diagonal modification
            y = y + (lam * jnp.maximum(
                jax.vmap(jnp.trace)(diag)[:, None] / 7.0, 1e-6) + 1e-8) * x
            return jnp.where(free[:, None], y, 0.0)

        def precond(x):
            return jnp.where(free[:, None],
                             jnp.einsum("kab,kb->ka", diag_inv, x,
                                        precision=_HI), 0.0)

        # preconditioned CG on the normal equations
        x0 = jnp.zeros((K, 7), S.dtype)
        r0 = -b - matvec(x0)
        z0 = precond(r0)

        def cg_body(c, _):
            x, rr, zz, p = c
            Ap = matvec(p)
            rz = jnp.sum(rr * zz)
            alpha = rz / jnp.maximum(jnp.sum(p * Ap), 1e-20)
            x = x + alpha * p
            rr2 = rr - alpha * Ap
            zz2 = precond(rr2)
            beta = jnp.sum(rr2 * zz2) / jnp.maximum(rz, 1e-20)
            return (x, rr2, zz2, zz2 + beta * p), None

        (dx, _, _, _), _ = jax.lax.scan(cg_body, (x0, r0, z0, z0), None,
                                        length=cg_iters)
        dx = jnp.where(free[:, None], dx, 0.0)

        S_new = lie.sim3_mul(lie.sim3_exp(dx), S)
        E_new = energy(S_new)
        accept = E_new < E_prev
        S = jnp.where(accept, S_new, S)
        lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-7), lam * 4.0)
        E = jnp.where(accept, E_new, E_prev)
        return (S, lam, E), None

    E0 = energy(S_init)
    (S, lam, E), _ = jax.lax.scan(
        lm_step, (S_init, jnp.asarray(lam0, S_init.dtype), E0), None,
        length=lm_iters)
    return PGOResult(S=S, energy=E, iterations=jnp.int32(lm_iters))


def build_edges(pose_edges, kf_index: dict, capacity: int,
                dtype=np.float64):
    """Host helper: pack PoseEdge records into static-capacity arrays.

    kf_index maps kf_id -> vertex index. Returns (ei, ej, S_meas, w)."""
    ei = np.zeros(capacity, np.int32)
    ej = np.zeros(capacity, np.int32)
    S_meas = np.tile(np.eye(4, dtype=dtype), (capacity, 1, 1))
    w = np.zeros(capacity, dtype)
    k = 0
    for e in pose_edges:
        if e.kf_a not in kf_index or e.kf_b not in kf_index or k >= capacity:
            continue
        ei[k] = kf_index[e.kf_a]
        ej[k] = kf_index[e.kf_b]
        # T_ab is already the full measured transform: SE3 (scale 1) for
        # odometry edges, Sim3 with the scale IN the rotation block for
        # loop edges (closing.py stores S_cur_cand verbatim; the
        # PoseEdge.scale field is metadata, NOT to be re-applied)
        S_meas[k] = np.asarray(e.T_ab, dtype)
        w[k] = 5.0 if e.kind == "loop" else 1.0
        k += 1
    return ei, ej, S_meas, w
