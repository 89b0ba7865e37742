"""Corner detection + oriented binary descriptors (ORB-style).

JAX redesign of the reference's LDSO additions
(reference: n-lalanne/LDSO src/frontend/FeatureDetector.cc — grid
FAST/Shi-Tomasi corners + 256-bit oriented-BRIEF descriptors on
keyframes, which feed corner-biased point selection, the DBoW loop
detector, and Sim(3) correspondence): instead of per-pixel C++ loops,
everything is dense map computation —
  * FAST-16 corner score via 16 rolled copies of the image and a
    doubled-mask contiguous-arc test (pure VPU),
  * Shi-Tomasi min-eigenvalue score via box-filtered structure tensors,
  * per-cell argmax grid selection to a fixed feature capacity,
  * intensity-centroid orientation + rotated-BRIEF sampling as batched
    bilinear gathers.

The 256 BRIEF sampling pairs are generated once from a fixed seed
(Gaussian, à la the BRIEF paper). Bit-level parity with OpenCV's table
is NOT a goal — the vocabulary is trained on these descriptors
(loop/vocab.py), so the pipeline is self-consistent.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ldso_tpu.kernels.interp import bilinear, in_bounds

# FAST-16 Bresenham circle of radius 3 (du, dv)
FAST_OFFSETS = np.asarray([
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
], dtype=np.int32)

PATCH_R = 15          # orientation patch radius (ORB uses 15)
DESC_BITS = 256
DESC_BYTES = 32


def _brief_pairs(seed: int = 7) -> np.ndarray:
    """[256, 4] (x1, y1, x2, y2) Gaussian sampling pairs in a 31x31 patch."""
    rng = np.random.default_rng(seed)
    sigma = (2 * PATCH_R + 1) / 5.0
    p = rng.normal(0.0, sigma, size=(DESC_BITS, 4))
    return np.clip(p, -PATCH_R, PATCH_R).astype(np.float32)

BRIEF_PAIRS = _brief_pairs()


class Features(NamedTuple):
    uv: jnp.ndarray        # f32 [N, 2]
    score: jnp.ndarray     # f32 [N]
    angle: jnp.ndarray     # f32 [N] radians
    desc: jnp.ndarray      # u8 [N, 32] packed 256-bit descriptor
    valid: jnp.ndarray     # bool [N]


def fast_score(img: jnp.ndarray, threshold: float = 20.0) -> jnp.ndarray:
    """[H, W] FAST-16 corner score: for pixels with ≥9 contiguous circle
    samples all brighter (or all darker) than center±t, the score is the
    min |I_c − I_p| over the best arc; else 0."""
    circ = jnp.stack([jnp.roll(img, (-int(dv), -int(du)), axis=(0, 1))
                      for du, dv in FAST_OFFSETS], axis=-1)       # [H, W, 16]
    d = circ - img[..., None]
    bright = d > threshold
    dark = d < -threshold

    def arc_score(mask, mag):
        # doubled mask: window-of-9 all-true test at every rotation
        m2 = jnp.concatenate([mask, mask], axis=-1)               # [H, W, 32]
        g2 = jnp.concatenate([mag, mag], axis=-1)
        best = jnp.zeros(img.shape, img.dtype)
        for s in range(16):
            w_ok = jnp.all(m2[..., s:s + 9], axis=-1)
            w_min = jnp.min(g2[..., s:s + 9], axis=-1)
            best = jnp.maximum(best, jnp.where(w_ok, w_min, 0.0))
        return best

    return jnp.maximum(arc_score(bright, d), arc_score(dark, -d))


def _box3(x):
    """3x3 box filter with edge clamp."""
    out = jnp.zeros_like(x)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            out = out + jnp.roll(x, (dy, dx), axis=(0, 1))
    return out / 9.0


def shi_tomasi_score(dx: jnp.ndarray, dy: jnp.ndarray) -> jnp.ndarray:
    """[H, W] min eigenvalue of the 3x3-windowed structure tensor."""
    a = _box3(dx * dx)
    b = _box3(dx * dy)
    c = _box3(dy * dy)
    tr = 0.5 * (a + c)
    det = jnp.sqrt(jnp.maximum(0.25 * (a - c) ** 2 + b * b, 0.0))
    return tr - det


@functools.partial(jax.jit, static_argnames=("max_features", "cell"))
def detect(img3: jnp.ndarray, max_features: int = 512, cell: int = 16,
           fast_th: float = 20.0) -> Features:
    """Grid corner detection + descriptors on a level-0 (I, dx, dy) stack
    (reference: FeatureDetector::DetectCorners)."""
    img = img3[..., 0]
    h, w = img.shape
    score = fast_score(img, fast_th)
    # Shi-Tomasi fallback so weakly-textured cells still yield corners
    st = shi_tomasi_score(img3[..., 1], img3[..., 2])
    score = jnp.where(score > 0, score + 1e3, st / (st.max() + 1e-6))

    # border exclusion: orientation/descriptor patch must fit
    m = PATCH_R + 1
    score = score.at[:m, :].set(0).at[-m:, :].set(0)
    score = score.at[:, :m].set(0).at[:, -m:].set(0)

    # per-cell argmax, then global top-k
    ch, cw = h // cell, w // cell
    s = score[: ch * cell, : cw * cell].reshape(ch, cell, cw, cell)
    s = s.transpose(0, 2, 1, 3).reshape(ch, cw, cell * cell)
    cidx = jnp.argmax(s, axis=-1)
    cbest = jnp.max(s, axis=-1)
    cy = jnp.arange(ch)[:, None] * cell + cidx // cell
    cx = jnp.arange(cw)[None, :] * cell + cidx % cell
    flat_scores = cbest.reshape(-1)
    flat_uv = jnp.stack([cx.reshape(-1), cy.reshape(-1)], axis=-1)

    k = min(max_features, flat_scores.shape[0])
    top, idx = jax.lax.top_k(flat_scores, k)
    uv = flat_uv[idx].astype(jnp.float32)
    valid = top > 0
    if k < max_features:
        pad = max_features - k
        uv = jnp.pad(uv, ((0, pad), (0, 0)))
        top = jnp.pad(top, (0, pad))
        valid = jnp.pad(valid, (0, pad))

    angle = _orientation(img, uv)
    desc = _brief(img, uv, angle)
    return Features(uv=uv, score=top, angle=angle, desc=desc, valid=valid)


def _orientation(img, uv):
    """Intensity-centroid angle (reference: IC_Angle in FeatureDetector)."""
    r = PATCH_R
    ys, xs = jnp.meshgrid(jnp.arange(-r, r + 1), jnp.arange(-r, r + 1),
                          indexing="ij")
    mask = (xs * xs + ys * ys) <= r * r
    pts = uv[:, None, None, :] + jnp.stack(
        [xs, ys], axis=-1)[None].astype(jnp.float32)             # [N,2r+1,2r+1,2]
    vals = bilinear(img, pts) * mask[None]
    m10 = jnp.sum(vals * xs[None], axis=(1, 2))
    m01 = jnp.sum(vals * ys[None], axis=(1, 2))
    return jnp.arctan2(m01, m10)


def _brief(img, uv, angle):
    """Rotated-BRIEF 256-bit descriptor, packed to u8[N, 32]."""
    pairs = jnp.asarray(BRIEF_PAIRS)                             # [256, 4]
    ca, sa = jnp.cos(angle), jnp.sin(angle)                      # [N]

    def rot(px, py):
        # [N, 256, 2] rotated offsets
        x = ca[:, None] * px[None] - sa[:, None] * py[None]
        y = sa[:, None] * px[None] + ca[:, None] * py[None]
        return jnp.stack([x, y], axis=-1)

    p1 = uv[:, None, :] + rot(pairs[:, 0], pairs[:, 1])
    p2 = uv[:, None, :] + rot(pairs[:, 2], pairs[:, 3])
    bits = (bilinear(img, p1) < bilinear(img, p2)).astype(jnp.uint8)  # [N, 256]
    b = bits.reshape(-1, DESC_BYTES, 8)
    weights = jnp.asarray([1, 2, 4, 8, 16, 32, 64, 128], jnp.uint8)
    return jnp.sum(b * weights[None, None, :], axis=-1).astype(jnp.uint8)


def unpack_bits(desc: jnp.ndarray) -> jnp.ndarray:
    """u8 [..., 32] -> f32 [..., 256] in {0, 1} (for matmul Hamming)."""
    shifts = jnp.asarray([0, 1, 2, 3, 4, 5, 6, 7], jnp.uint8)
    bits = (desc[..., :, None] >> shifts[None, :]) & 1
    return bits.reshape(*desc.shape[:-1], DESC_BITS).astype(jnp.float32)
