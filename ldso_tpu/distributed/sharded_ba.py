"""Distributed sliding-window BA: point-sharded Schur assembly.

The reference is a single-process CPU system (SURVEY.md §2.3/§5.8 — no
NCCL/MPI anywhere); this module is a new scaling axis:
the landmark/residual set is sharded across the device mesh
(`PartitionSpec` on the point axis), each device linearizes its
residual shard and Schur-eliminates its own points LOCALLY (point
elimination is per-point-local, so it needs no communication), and the
only collective per Gauss-Newton iteration is one `psum` of the tiny
(8F+4)² reduced camera system. The dense solve is replicated
(≤68×68); idepth backsubstitution is per-shard local.

Works identically on a mesh of GPUs and on the CPU fake mesh
(`--xla_force_host_platform_device_count`), which is how it is tested.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ldso_tpu.ba.residuals import assemble
from ldso_tpu.ba.solve import apply_step
from ldso_tpu.config import LdsoConfig
from ldso_tpu.core.window import Window, state_delta

_HI = jax.lax.Precision.HIGHEST

AXIS = "points"   # 1-D mesh axis name the landmark bank is sharded over


def window_pspecs(win: Window, axes=AXIS) -> Window:
    """PartitionSpec pytree for a Window: point-indexed arrays sharded on
    the given mesh axis (or axis tuple — e.g. ("proc", "local") to spread
    points over hosts × chips), frame/camera state replicated."""
    pa = P(axes)
    return Window(
        frame_valid=P(), T_eval=P(), x=P(), x_zero=P(), exposure=P(),
        images=P(), c=P(), c_zero=P(),
        p_valid=pa, p_host=pa, p_uv=pa, p_color=pa,
        p_weight=pa, p_idepth=pa, p_idepth_zero=pa,
        res_mask=pa,
    )


def _local_gn_step(win: Window, HM, bM, prior_d, scale_vec, fixed, lam,
                   huber_th: float, outlier_sum: float, axes=AXIS):
    """One GN step, executed per shard inside shard_map: local residual
    linearization + local Schur elimination, one psum, replicated solve,
    local backsubstitution. Returns (dx [D] replicated, dd [P_local])."""
    sys = assemble(win, huber_th=huber_th, outlier_sum=outlier_sum)

    delta = state_delta(win)
    # local camera-system contribution, then the single collective
    Hdd_damped = (sys.H_dd * (1.0 + lam)) + 1e-10
    active = win.p_valid & (sys.H_dd > 1e-10)
    inv_dd = jnp.where(active, 1.0 / Hdd_damped, 0.0)
    H_sc = jnp.matmul(sys.H_xd.T, sys.H_xd * inv_dd[:, None], precision=_HI)
    b_sc = jnp.matmul(sys.H_xd.T, sys.b_d * inv_dd, precision=_HI)

    # ONE collective of D² + 2D + 1 floats. The solver needs ΣH and
    # ΣH_sc separately ONLY on the diagonal (damping multiplies the
    # undamped total diagonal BEFORE the Schur subtraction), so the
    # payload carries the combined M = Σ(H − H_sc) plus diag(ΣH) — the
    # Schur diagonal is then dH − diag(M) — instead of both full
    # matrices (a [2,D,D] stack would move 2× the bytes).
    D = sys.H.shape[0]
    payload = jnp.concatenate([
        (sys.H - H_sc).ravel(),
        jnp.diagonal(sys.H),
        sys.b - b_sc,
        sys.energy[None],
    ])
    tot = jax.lax.psum(payload, axes)
    M = tot[: D * D].reshape(D, D)
    dH = tot[D * D: D * D + D]
    b_comb = tot[D * D + D: D * D + 2 * D]
    E = tot[-1]

    # replicated tiny solve (every device computes the same dx); damping
    # order matches the single-device solver (_solve_core): damp the
    # undamped total diagonal, THEN subtract the Schur term
    from ldso_tpu.ba.solve import prior_offset

    H = M + HM + jnp.diag(prior_d)
    b = (b_comb + bM + jnp.matmul(HM, delta, precision=_HI)
         + prior_d * (delta + prior_offset(win)))  # absolute affine prior
    diag_f = ((dH + jnp.diagonal(HM) + prior_d) * (1.0 + lam)
              - (dH - jnp.diagonal(M)))
    H = H.at[jnp.arange(D), jnp.arange(D)].set(diag_f)
    H = jnp.where(fixed[:, None] | fixed[None, :], 0.0, H)
    H = H.at[jnp.arange(D), jnp.arange(D)].add(jnp.where(fixed, 1.0, 0.0))
    b = jnp.where(fixed, 0.0, b)

    S = scale_vec
    Hs = H * S[:, None] * S[None, :]
    bs = b * S
    pc = 1.0 / jnp.sqrt(jnp.diag(Hs) + 10.0)
    y = jnp.linalg.solve(Hs * pc[:, None] * pc[None, :], bs * pc)
    dx = -(S * pc * y)
    dx = jnp.where(fixed, 0.0, dx)

    # local backsubstitution for this shard's idepths
    dd = jnp.where(active,
                   -(sys.b_d + jnp.matmul(sys.H_xd, dx, precision=_HI)) * inv_dd,
                   0.0)
    return dx, dd, E


def make_distributed_ba_step(mesh: Mesh, cfg: LdsoConfig,
                             huber_th: float | None = None):
    """Build the jitted multi-device GN step: Window (points sharded) →
    (Window', energy). One psum per call (SURVEY.md §5.8)."""
    from ldso_tpu.ba.solve import fix_mask, prior_diag, scale_vector

    F = cfg.shapes.max_frames
    huber = float(huber_th if huber_th is not None else cfg.ba.huber_th)
    osum = float(cfg.ba.outlier_th_sum_component)
    s_vec = jnp.asarray(scale_vector(F, cfg.scales))
    fixed = jnp.asarray(fix_mask(F, 0))

    axes = tuple(mesh.axis_names)
    axes = axes[0] if len(axes) == 1 else axes
    pspec = window_pspecs(None, axes)  # field specs only; window not needed

    sharded = jax.shard_map(
        functools.partial(_local_gn_step, huber_th=huber, outlier_sum=osum,
                          axes=axes),
        mesh=mesh,
        in_specs=(pspec, P(), P(), P(), P(), P(), P()),
        out_specs=(P(), P(axes), P()),
        check_vma=False,
    )

    @jax.jit
    def step(win: Window, HM, bM, prior_d, lam):
        dx, dd, E = sharded(win, HM, bM, prior_d, s_vec, fixed, lam)
        return apply_step(win, dx, dd), E

    def full(win: Window, HM, bM, lam=1e-5):
        valid = np.asarray(win.frame_valid)
        prior_d = jnp.asarray(prior_diag(valid, cfg), jnp.float32)
        return step(win, jnp.asarray(HM, jnp.float32),
                    jnp.asarray(bM, jnp.float32), prior_d,
                    jnp.float32(lam))

    return full


def shard_window(win: Window, mesh: Mesh) -> Window:
    """Place a Window on the mesh with the point axis sharded."""
    axes = tuple(mesh.axis_names)
    specs = window_pspecs(win, axes[0] if len(axes) == 1 else axes)
    return jax.tree.map(
        lambda x, s: jax.device_put(x, jax.sharding.NamedSharding(mesh, s)),
        win, specs)


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.asarray(devs[:n]), (AXIS,))
