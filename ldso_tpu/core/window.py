"""The sliding-window state: fixed-capacity pytrees with validity masks.

JAX redesign of the reference's dual Frame/FrameHessian +
Point/PointHessian representation (reference: n-lalanne/LDSO
include/internal/{FrameHessian,PointHessian}.h, src/Frame.cc): instead of
heap-allocated per-object records, the whole window is a struct-of-arrays
pytree with static capacities (SURVEY.md §7.0) — window slots ``F``,
point bank ``P`` — so every BA/tracker program has static shapes and the
point lifecycle is mask/slot bookkeeping on the host conductor.

State parameterization (mirrors FrameHessian::state / state_zero, the
First-Estimate-Jacobian machinery):
  * per frame: ``T_eval`` is the worldToCam SE(3) evaluation point fixed
    at keyframe insertion; the 8-dim state ``x = [xi(6), a, b]`` holds the
    accumulated left-tangent pose delta (``T = exp(xi)·T_eval``) and the
    affine brightness params. ``x_zero`` is the linearization state
    (pose part 0 by construction; affine at insertion).
  * camera: 4 intrinsics ``c`` with FEJ copy ``c_zero`` (CalibHessian).
  * points: inverse depth in host frame (+ FEJ copy), 8-pattern host
    colors and static gradient weights (PointHessian equivalents).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ldso_tpu.config import PATTERN, LdsoConfig
from ldso_tpu.math import lie

PATTERN_OFFSETS = np.asarray(PATTERN, dtype=np.float32)  # [8, 2]


@jax.jit
def _current_pose_jit(x, T_eval):
    return lie.se3_mul(lie.se3_exp(x[:, :6]), T_eval)


class Window(NamedTuple):
    """Device-resident window state (a single pytree)."""

    # frames — slot-indexed, capacity F
    frame_valid: jnp.ndarray     # bool [F]
    T_eval: jnp.ndarray          # f32 [F, 4, 4] worldToCam FEJ evaluation points
    x: jnp.ndarray               # f32 [F, 8] current state [xi(6), a, b]
    x_zero: jnp.ndarray          # f32 [F, 8] FEJ state
    exposure: jnp.ndarray        # f32 [F] exposure times (1.0 if unknown)
    images: jnp.ndarray          # f32 [F, H, W, 3] level-0 (I, dx, dy)

    # camera intrinsics (optimized: the CPARS=4 state)
    c: jnp.ndarray               # f32 [4]
    c_zero: jnp.ndarray          # f32 [4]

    # active point bank — capacity P
    p_valid: jnp.ndarray         # bool [P]
    p_host: jnp.ndarray          # i32 [P] window slot of host frame
    p_uv: jnp.ndarray            # f32 [P, 2] pixel in host frame (level 0)
    p_color: jnp.ndarray         # f32 [P, 8] host pattern intensities
    p_weight: jnp.ndarray        # f32 [P, 8] static sqrt gradient weights
    p_idepth: jnp.ndarray        # f32 [P]
    p_idepth_zero: jnp.ndarray   # f32 [P]
    res_mask: jnp.ndarray        # bool [P, F] active residual (point, target) pairs

    @property
    def num_frames(self) -> int:
        return self.T_eval.shape[0]

    @property
    def num_points(self) -> int:
        return self.p_uv.shape[0]

    def current_pose(self, slot=None):
        """worldToCam of slot(s): exp(xi)·T_eval.

        Jitted: called EAGERLY (outside any jit) this chain is dozens of
        tiny ops, each a separate dispatch. Inside a jit the inner jit
        inlines, so traced callers are unaffected."""
        T = _current_pose_jit(self.x, self.T_eval)
        return T if slot is None else T[slot]


def empty_window(cfg: LdsoConfig, h: int, w: int, intr) -> Window:
    F = cfg.shapes.max_frames
    P = cfg.shapes.max_points
    eye = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (F, 4, 4))
    return Window(
        frame_valid=jnp.zeros(F, dtype=bool),
        T_eval=eye,
        x=jnp.zeros((F, 8), jnp.float32),
        x_zero=jnp.zeros((F, 8), jnp.float32),
        exposure=jnp.ones(F, jnp.float32),
        images=jnp.zeros((F, h, w, 3), jnp.float32),
        c=jnp.asarray(intr, jnp.float32),
        c_zero=jnp.asarray(intr, jnp.float32),
        p_valid=jnp.zeros(P, dtype=bool),
        p_host=jnp.zeros(P, jnp.int32),
        p_uv=jnp.zeros((P, 2), jnp.float32),
        p_color=jnp.zeros((P, 8), jnp.float32),
        p_weight=jnp.ones((P, 8), jnp.float32),
        p_idepth=jnp.full((P,), 1.0, jnp.float32),
        p_idepth_zero=jnp.full((P,), 1.0, jnp.float32),
        res_mask=jnp.zeros((P, F), dtype=bool),
    )


def state_delta(win: Window) -> jnp.ndarray:
    """Stacked delta from the FEJ linearization point, [8F + 4].

    Layout: frame blocks [8 each, slots 0..F-1] then camera [4] — the
    coordinate system of the marginalization prior HM/bM (reference:
    EnergyFunctional::setDeltaF)."""
    dx = (win.x - win.x_zero).reshape(-1)
    dc = win.c - win.c_zero
    return jnp.concatenate([dx, dc])


@jax.jit
def insert_frame(
    win: Window,
    slot: int,
    T_init,                # [4, 4] worldToCam initial pose
    image,                 # [H, W, 3] level-0 stack
    exposure: float,
    aff_ab=(0.0, 0.0),
) -> Window:
    """Host-side window op: occupy a slot with a new keyframe.

    The new frame's evaluation point is its initial pose; pose state and
    FEJ state start at zero (reference: FrameHessian::setEvalPT_scaled)."""
    x0 = jnp.zeros(8, jnp.float32) \
        .at[6].set(jnp.float32(aff_ab[0])).at[7].set(jnp.float32(aff_ab[1]))
    return win._replace(
        frame_valid=win.frame_valid.at[slot].set(True),
        T_eval=win.T_eval.at[slot].set(jnp.asarray(T_init, jnp.float32)),
        x=win.x.at[slot].set(x0),
        x_zero=win.x_zero.at[slot].set(x0),
        exposure=win.exposure.at[slot].set(jnp.float32(exposure)),
        images=win.images.at[slot].set(jnp.asarray(image, jnp.float32)),
    )


@jax.jit
def remove_frame(win: Window, slot: int) -> Window:
    """Free a slot: invalidate the frame, its hosted points, and every
    residual targeting it."""
    hosted = win.p_host == slot
    return win._replace(
        frame_valid=win.frame_valid.at[slot].set(False),
        p_valid=win.p_valid & ~hosted,
        res_mask=(win.res_mask & ~hosted[:, None]).at[:, slot].set(False),
    )


@jax.jit
def add_points(
    win: Window,
    slots: np.ndarray,        # [K] point-bank slots to fill (entry >= P drops)
    host_slot: int,
    uv: np.ndarray,           # [K, 2]
    color: np.ndarray,        # [K, 8]
    weight: np.ndarray,       # [K, 8]
    idepth: np.ndarray,       # [K]
) -> Window:
    """Activate points into bank slots; residuals toward all other valid
    frames are switched on (reference: FullSystem::activatePointsMT →
    ef->insertResidual for every other KF).

    Scatters use mode="drop": callers pad ``slots`` with the capacity
    index so every call has ONE static shape — data-dependent shapes
    would force a device recompile per batch size."""
    slots = jnp.asarray(slots)
    targets = win.frame_valid.at[host_slot].set(False)  # all valid frames except host
    res_rows = jnp.broadcast_to(targets, (slots.shape[0], win.num_frames))
    idep = jnp.asarray(idepth, jnp.float32)
    return win._replace(
        p_valid=win.p_valid.at[slots].set(True, mode="drop"),
        p_host=win.p_host.at[slots].set(host_slot, mode="drop"),
        p_uv=win.p_uv.at[slots].set(jnp.asarray(uv, jnp.float32), mode="drop"),
        p_color=win.p_color.at[slots].set(jnp.asarray(color, jnp.float32),
                                          mode="drop"),
        p_weight=win.p_weight.at[slots].set(jnp.asarray(weight, jnp.float32),
                                            mode="drop"),
        p_idepth=win.p_idepth.at[slots].set(idep, mode="drop"),
        p_idepth_zero=win.p_idepth_zero.at[slots].set(idep, mode="drop"),
        res_mask=win.res_mask.at[slots].set(res_rows, mode="drop"),
    )


@jax.jit
def drop_points(win: Window, mask) -> Window:
    """Deactivate points (mask [P] True = drop)."""
    keep = ~jnp.asarray(mask)
    return win._replace(
        p_valid=win.p_valid & keep,
        res_mask=win.res_mask & keep[:, None],
    )


@jax.jit
def connect_new_frame(win: Window, slot: int) -> Window:
    """After inserting a KF, switch on residuals from every active point
    toward it (except points it hosts)."""
    return win._replace(
        res_mask=win.res_mask.at[:, slot].set(win.p_valid & (win.p_host != slot))
    )


@functools.partial(jax.jit, static_argnames=("outlier_sum",))
def activate_points_device(
    win: Window,
    slots,                    # [K] i32 point-bank slots to fill (>= P drops)
    host,                     # [K] i32 per-point host window slot
    uv,                       # [K, 2] f32 pixel in host frame
    idepth,                   # [K] f32
    outlier_sum: float = 2500.0,
) -> Window:
    """Multi-host activation in ONE dispatch: samples each point's
    8-pattern colors + static gradient weights from its HOST frame's
    image (static loop over the F window slots, masked accumulate) and
    scatters everything into the bank (reference: activatePointsMT →
    PointHessian ctor + ef->insertResidual; the old per-host-slot loop
    paid one device round trip per slot)."""
    F = win.num_frames
    pat = jnp.asarray(PATTERN_OFFSETS)
    uvp = uv[:, None, :] + pat[None]                         # [K, 8, 2]
    color = jnp.zeros((uv.shape[0], 8), jnp.float32)
    gsq = jnp.zeros((uv.shape[0], 8), jnp.float32)
    from ldso_tpu.kernels.interp import bilinear33
    for f in range(F):
        hit = bilinear33(win.images[f], uvp)                 # [K, 8, 3]
        m = (host == f)[:, None]
        color = jnp.where(m, hit[..., 0], color)
        gsq = jnp.where(m, jnp.sum(hit[..., 1:3] ** 2, axis=-1), gsq)
    weight = jnp.sqrt(outlier_sum / (outlier_sum + gsq))

    slots = jnp.asarray(slots)
    host = jnp.asarray(host, jnp.int32)
    res_rows = win.frame_valid[None, :] \
        & (jnp.arange(F)[None, :] != host[:, None])          # [K, F]
    idep = jnp.asarray(idepth, jnp.float32)
    return win._replace(
        p_valid=win.p_valid.at[slots].set(True, mode="drop"),
        p_host=win.p_host.at[slots].set(host, mode="drop"),
        p_uv=win.p_uv.at[slots].set(jnp.asarray(uv, jnp.float32), mode="drop"),
        p_color=win.p_color.at[slots].set(color, mode="drop"),
        p_weight=win.p_weight.at[slots].set(weight, mode="drop"),
        p_idepth=win.p_idepth.at[slots].set(idep, mode="drop"),
        p_idepth_zero=win.p_idepth_zero.at[slots].set(idep, mode="drop"),
        res_mask=win.res_mask.at[slots].set(res_rows, mode="drop"),
    )
