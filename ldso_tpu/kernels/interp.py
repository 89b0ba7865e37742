"""Bilinear interpolation gathers over images and (I, dx, dy) stacks.

JAX replacement for the reference's hot interpolation templates
``getInterpolatedElement31 / getInterpolatedElement33``
(reference: n-lalanne/LDSO include/internal/GlobalFuncs.h) — used in every
photometric residual, the tracker, and the epipolar tracer.

All functions are batched over arbitrary leading dims of the sample
coordinates and clamp out-of-bounds samples (callers carry a validity
mask; see :func:`in_bounds`).
"""

from __future__ import annotations

import jax.numpy as jnp


def in_bounds(uv, w: int, h: int, border: float = 1.0):
    """Validity mask for bilinear sampling with a safety border (px)."""
    u, v = uv[..., 0], uv[..., 1]
    return (u >= border) & (u < w - 1 - border) & (v >= border) & (v < h - 1 - border)


def _gather2d(img, iu, iv):
    """img [H, W, C] or [H, W]; integer index gather with clamping."""
    h, w = img.shape[0], img.shape[1]
    iu = jnp.clip(iu, 0, w - 1)
    iv = jnp.clip(iv, 0, h - 1)
    flat = img.reshape((h * w,) + img.shape[2:])
    return flat[iv * w + iu]


def bilinear(img, uv):
    """Bilinear sample: img [H, W] or [H, W, C], uv [..., 2] -> [...] or [..., C]."""
    u, v = uv[..., 0], uv[..., 1]
    u0 = jnp.floor(u).astype(jnp.int32)
    v0 = jnp.floor(v).astype(jnp.int32)
    du = (u - u0.astype(u.dtype))
    dv = (v - v0.astype(v.dtype))
    if img.ndim == 3:
        du = du[..., None]
        dv = dv[..., None]
    p00 = _gather2d(img, u0, v0)
    p10 = _gather2d(img, u0 + 1, v0)
    p01 = _gather2d(img, u0, v0 + 1)
    p11 = _gather2d(img, u0 + 1, v0 + 1)
    top = p00 * (1.0 - du) + p10 * du
    bot = p01 * (1.0 - du) + p11 * du
    return top * (1.0 - dv) + bot * dv


def bilinear33(img3, uv):
    """Sample an (I, dx, dy) stack: img3 [H, W, 3], uv [..., 2] -> [..., 3].

    The reference interpolates intensity and both gradients with shared
    bilinear weights (getInterpolatedElement33) — identical here.
    """
    return bilinear(img3, uv)


def pack_corners(img):
    """Pre-pack the 2x2 bilinear footprint: [H, W, C] -> [H, W, 4C].

    packed[v, u] = concat(img[v, u], img[v, u+1], img[v+1, u],
    img[v+1, u+1]) (border rows/cols replicate). Turns every bilinear
    sample from 4 random gathers into ONE — the gather is the
    memory-latency-bound part of the residual hot loop, so the 4x
    footprint memory is traded for a ~4x cut in gather count. Built once
    per frame (or per linearization), amortized over all samples.
    """
    right = jnp.concatenate([img[:, 1:], img[:, -1:]], axis=1)
    down = jnp.concatenate([img[1:], img[-1:]], axis=0)
    down_right = jnp.concatenate([down[:, 1:], down[:, -1:]], axis=1)
    return jnp.concatenate([img, right, down, down_right], axis=-1)


def bilinear_packed(packed, uv, c: int):
    """Bilinear sample from a corner-packed image (see pack_corners).

    packed: [H, W, 4C]; uv: [..., 2]; c: the original channel count C.
    Returns [..., C]. One gather per sample instead of four.
    """
    u, v = uv[..., 0], uv[..., 1]
    u0 = jnp.floor(u).astype(jnp.int32)
    v0 = jnp.floor(v).astype(jnp.int32)
    du = (u - u0.astype(u.dtype))[..., None]
    dv = (v - v0.astype(v.dtype))[..., None]
    corners = _gather2d(packed, u0, v0)          # [..., 4C]
    shp = corners.shape[:-1] + (4, c)
    corners = corners.reshape(shp)
    top = corners[..., 0, :] * (1.0 - du) + corners[..., 1, :] * du
    bot = corners[..., 2, :] * (1.0 - du) + corners[..., 3, :] * du
    return top * (1.0 - dv) + bot * dv


def remap_image(img, remap):
    """Apply an undistortion remap grid.

    img: [H_in, W_in] raw image; remap: [H_out, W_out, 2] sample positions
    (-1 marks invalid). Returns [H_out, W_out] with invalid pixels = 0.
    """
    out = bilinear(img, remap)
    valid = remap[..., 0] >= 0
    return jnp.where(valid, out, 0.0)
