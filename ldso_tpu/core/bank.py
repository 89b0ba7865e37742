"""Device-resident immature (candidate) point bank.

JAX redesign of the reference's per-keyframe
``std::vector<ImmaturePoint*>`` (reference: n-lalanne/LDSO
src/internal/ImmaturePoint.cc, FullSystem's immature-point lifecycle):
one flat fixed-capacity struct-of-arrays pytree that lives on the device so the
per-frame epipolar trace updates it **without any host round trip** —
the bank is input and output of the jitted trace step. Host lifecycle
ops (activation into the window's point bank, candidate re-seeding,
culling at marginalization) pull one snapshot per keyframe, mutate in
numpy, and push back — two transfers per KF instead of four per frame.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ldso_tpu import trace as trace_mod


class Bank(NamedTuple):
    """Immature-point store (capacity N, device-resident)."""

    valid: jnp.ndarray          # bool [N]
    host_slot: jnp.ndarray      # i32 [N] window slot of host keyframe
    uv: jnp.ndarray             # f32 [N, 2] pixel in host frame
    color: jnp.ndarray          # f32 [N, 8] host pattern intensities
    weight: jnp.ndarray         # f32 [N, 8] static gradient weights
    idepth_min: jnp.ndarray     # f32 [N]
    idepth_max: jnp.ndarray     # f32 [N]  (NaN = never traced)
    quality: jnp.ndarray        # f32 [N] best/second-best trace ratio
    last_status: jnp.ndarray    # i32 [N] last trace status
    outlier_count: jnp.ndarray  # i32 [N] consecutive-outlier strikes
    is_corner: jnp.ndarray      # bool [N] corner-seeded candidate (LDSO bias)

    @property
    def capacity(self) -> int:
        return self.uv.shape[0]


def empty_bank(capacity: int) -> Bank:
    n = capacity
    return Bank(
        valid=jnp.zeros(n, dtype=bool),
        host_slot=jnp.zeros(n, jnp.int32),
        uv=jnp.zeros((n, 2), jnp.float32),
        color=jnp.zeros((n, 8), jnp.float32),
        weight=jnp.ones((n, 8), jnp.float32),
        idepth_min=jnp.zeros(n, jnp.float32),
        idepth_max=jnp.full(n, jnp.nan, jnp.float32),
        quality=jnp.zeros(n, jnp.float32),
        last_status=jnp.full(n, trace_mod.UNINITIALIZED, jnp.int32),
        outlier_count=jnp.zeros(n, jnp.int32),
        is_corner=jnp.zeros(n, dtype=bool),
    )


@dataclasses.dataclass
class HostBank:
    """Numpy snapshot of a Bank for host-side lifecycle surgery."""

    valid: np.ndarray
    host_slot: np.ndarray
    uv: np.ndarray
    color: np.ndarray
    weight: np.ndarray
    idepth_min: np.ndarray
    idepth_max: np.ndarray
    quality: np.ndarray
    last_status: np.ndarray
    outlier_count: np.ndarray
    is_corner: np.ndarray

    @property
    def capacity(self) -> int:
        return self.uv.shape[0]

    def free_slots(self, k: int) -> np.ndarray:
        idx = np.flatnonzero(~self.valid)
        return idx[:k]

    def drop(self, mask: np.ndarray) -> None:
        self.valid &= ~mask


def to_host(bank: Bank) -> HostBank:
    # ONE batched device→host transfer (sequential np.asarray would
    # wait on the device once per field)
    import jax

    vals = jax.device_get(bank)
    return HostBank(**{f: np.array(getattr(vals, f))
                       for f in Bank._fields})


@jax.jit
def apply_patch(bank: Bank, drop_mask, seed_slots, seed_uv, seed_color,
                seed_weight, seed_host_slot, seed_is_corner) -> Bank:
    """Apply a keyframe's lifecycle surgery to the LIVE device bank in
    one dispatch: drop rows (activated candidates, dying hosts), then
    scatter fresh seeds into free slots.

    Unlike the old snapshot→host-mutate→full-upload cycle, a patch is
    safe under CONCURRENT tracing (batch mode: the tracking thread's
    fused program keeps evolving the bank while the mapping thread
    builds the KF): tracing only updates or invalidates rows that are
    valid, never occupies free ones, so drops and seed scatters commute
    with any traces that landed since the snapshot. ``seed_slots`` is
    padded with an out-of-range index (mode="drop" discards those).
    Seeds start exactly as the host writer did: interval [0, NaN),
    UNINITIALIZED, zero quality/strikes (reference: ImmaturePoint ctor).
    """
    from ldso_tpu import trace as _t

    sl = seed_slots
    return Bank(
        valid=(bank.valid & ~drop_mask).at[sl].set(True, mode="drop"),
        host_slot=bank.host_slot.at[sl].set(seed_host_slot, mode="drop"),
        uv=bank.uv.at[sl].set(seed_uv, mode="drop"),
        color=bank.color.at[sl].set(seed_color, mode="drop"),
        weight=bank.weight.at[sl].set(seed_weight, mode="drop"),
        idepth_min=bank.idepth_min.at[sl].set(0.0, mode="drop"),
        idepth_max=bank.idepth_max.at[sl].set(jnp.nan, mode="drop"),
        quality=bank.quality.at[sl].set(0.0, mode="drop"),
        last_status=bank.last_status.at[sl].set(_t.UNINITIALIZED,
                                                mode="drop"),
        outlier_count=bank.outlier_count.at[sl].set(0, mode="drop"),
        is_corner=bank.is_corner.at[sl].set(seed_is_corner, mode="drop"),
    )


@jax.jit
def drop_rows(bank: Bank, mask) -> Bank:
    """Invalidate rows (one dispatch) — the activation half of a
    keyframe's bank surgery when the seed half comes later."""
    return bank._replace(valid=bank.valid & ~mask)


@jax.jit
def drop_hosted(bank: Bank, dying_mask) -> Bank:
    """Invalidate candidates hosted by dying window slots
    (``dying_mask`` [F] bool). The deferred-finish KF path commits this
    as its own journaled patch: seeds go in at BUILD time (so tracing
    starts immediately), the marginalization cull lands one readback
    later when the frame flags are known."""
    return bank._replace(valid=bank.valid & ~dying_mask[bank.host_slot])


def from_host(hb: HostBank) -> Bank:
    return Bank(
        valid=jnp.asarray(hb.valid),
        host_slot=jnp.asarray(hb.host_slot, jnp.int32),
        uv=jnp.asarray(hb.uv, jnp.float32),
        color=jnp.asarray(hb.color, jnp.float32),
        weight=jnp.asarray(hb.weight, jnp.float32),
        idepth_min=jnp.asarray(hb.idepth_min, jnp.float32),
        idepth_max=jnp.asarray(hb.idepth_max, jnp.float32),
        quality=jnp.asarray(hb.quality, jnp.float32),
        last_status=jnp.asarray(hb.last_status, jnp.int32),
        outlier_count=jnp.asarray(hb.outlier_count, jnp.int32),
        is_corner=jnp.asarray(hb.is_corner, bool),
    )
