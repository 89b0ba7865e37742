"""Image pyramid + gradient construction.

Equivalent of ``FrameHessian::makeImages`` (reference:
n-lalanne/LDSO src/internal/FrameHessian.cc): per pyramid level an
(I, dx, dy) stack and the squared gradient magnitude used by pixel
selection. Levels are built by 2x2 averaging (as the reference does),
gradients by central differences.

Shapes are static per level; the whole build is one fused XLA program
per frame (avg-pool + shifts — bandwidth-bound, which is the natural
limit for this op).
"""

from __future__ import annotations

from typing import List, Tuple

import jax.numpy as jnp


def level_shapes(w: int, h: int, levels: int) -> List[Tuple[int, int]]:
    """Per-level (w, h); requires divisibility so all levels are exact
    (reference: setGlobalCalib masks wG/hG to multiples of 2^levels)."""
    shapes = []
    for l in range(levels):
        assert w % (1 << l) == 0 and h % (1 << l) == 0, (
            f"image {w}x{h} not divisible at level {l}; crop to a multiple of "
            f"{1 << (levels - 1)}"
        )
        shapes.append((w >> l, h >> l))
    return shapes


def crop_to_multiple(img, levels: int):
    """Crop bottom/right so both dims divide by 2^(levels-1)."""
    m = 1 << (levels - 1)
    h, w = img.shape[-2], img.shape[-1]
    return img[..., : (h // m) * m, : (w // m) * m]


def _downsample2(img):
    """2x2 average pooling, [H, W] -> [H/2, W/2]."""
    h, w = img.shape
    return img.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))


def _gradients(img):
    """Central differences with clamped borders: [H, W] -> dx, dy."""
    right = jnp.roll(img, -1, axis=1).at[:, -1].set(img[:, -1])
    left = jnp.roll(img, 1, axis=1).at[:, 0].set(img[:, 0])
    down = jnp.roll(img, -1, axis=0).at[-1, :].set(img[-1, :])
    up = jnp.roll(img, 1, axis=0).at[0, :].set(img[0, :])
    dx = 0.5 * (right - left)
    dy = 0.5 * (down - up)
    return dx, dy


def build_pyramid(img, levels: int):
    """img [H, W] -> (pyramid, grad_sq):
      pyramid: list of [H_l, W_l, 3] (I, dx, dy) stacks, finest first
      grad_sq: list of [H_l, W_l] squared gradient magnitude (absSquaredGrad)

    Plain jnp: the five-level build at 640x480 moves ~7.8 MB, and XLA
    fuses it into the per-frame program that consumes it.
    """
    pyr = []
    gsq = []
    cur = jnp.asarray(img).astype(jnp.float32)  # uint8 frames widen on-device
    for l in range(levels):
        dx, dy = _gradients(cur)
        pyr.append(jnp.stack([cur, dx, dy], axis=-1))
        gsq.append(dx * dx + dy * dy)
        if l + 1 < levels:
            cur = _downsample2(cur)
    return pyr, gsq

