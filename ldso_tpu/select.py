"""Candidate pixel selection by adaptive gradient thresholds.

JAX redesign of the reference's ``PixelSelector2``
(reference: n-lalanne/LDSO src/frontend/PixelSelector2.cc): per-block
gradient-magnitude quantile thresholds (``makeHists``: 32x32 blocks,
median + ``setting_minGradHistAdd``), then per-cell maximum selection at
three potential scales (d, 2d, 4d) with a deterministic hashed direction
dither replacing the reference's random dither (bitwise reproducibility,
SURVEY.md §4), and a final top-k to a fixed candidate capacity.

Everything is reshape/argmax vectorized — no Python over pixels.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _block_quantile_threshold(gsq, block: int, cut: float, add: float):
    """Per-block threshold = quantile(|grad|, cut) + add, upsampled to
    pixels with 3x3 block smoothing (reference: makeHists + smoothed ths)."""
    h, w = gsq.shape
    bh, bw = h // block, w // block
    g = jnp.sqrt(gsq[: bh * block, : bw * block])
    blocks = g.reshape(bh, block, bw, block).transpose(0, 2, 1, 3).reshape(bh, bw, -1)
    th = jnp.quantile(blocks, cut, axis=-1) + add                  # [bh, bw]
    # 3x3 smoothing over blocks
    thp = jnp.pad(th, 1, mode="edge")
    th_s = sum(
        thp[1 + dy : 1 + dy + bh, 1 + dx : 1 + dx + bw]
        for dy in (-1, 0, 1) for dx in (-1, 0, 1)
    ) / 9.0
    th_pix = jnp.repeat(jnp.repeat(th_s, block, 0), block, 1)
    th_full = jnp.full((h, w), 1e9, gsq.dtype)
    return th_full.at[: bh * block, : bw * block].set(th_pix)


@functools.lru_cache(maxsize=1)
def _dir_table() -> np.ndarray:
    """[65536, 2] unit direction of every 16-bit hash, rounded to float32
    once from float64."""
    ang = np.arange(65536, dtype=np.float64) / 65536.0 * 2 * np.pi
    return np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)


def _hash_dirs(h: int, w: int, cell: int, seed):
    """Deterministic per-cell unit direction (replaces the reference's
    randomPattern dither). ``seed`` may be traced: the low 16 bits of the
    hash split into a static per-cell part and the seed's part, so one
    compiled program serves every seed."""
    ch, cw = h // cell + 1, w // cell + 1
    iy = np.arange(ch, dtype=np.int64)[:, None]
    ix = np.arange(cw, dtype=np.int64)[None, :]
    cell_hash = ((iy * 73856093 ^ ix * 19349663) & 0xFFFF).astype(np.uint32)
    seed_hash = (jnp.asarray(seed).astype(jnp.uint32)
                 * jnp.uint32(83492791)) & jnp.uint32(0xFFFF)
    return jnp.asarray(_dir_table())[jnp.asarray(cell_hash) ^ seed_hash]


def _cell_argmax(score, cell: int):
    """Winner mask: per cell of size `cell`, the argmax pixel (if score>0)."""
    h, w = score.shape
    ch, cw = h // cell, w // cell
    s = score[: ch * cell, : cw * cell].reshape(ch, cell, cw, cell)
    s = s.transpose(0, 2, 1, 3).reshape(ch, cw, cell * cell)
    idx = jnp.argmax(s, axis=-1)
    best = jnp.max(s, axis=-1)
    onehot = jax.nn.one_hot(idx, cell * cell, dtype=score.dtype) * (best > 0)[..., None]
    m = onehot.reshape(ch, cw, cell, cell).transpose(0, 2, 1, 3).reshape(ch * cell, cw * cell)
    out = jnp.zeros_like(score)
    return out.at[: ch * cell, : cw * cell].set(m)


@functools.partial(jax.jit, static_argnames=("num_want", "block", "pot"))
def select_pixels(
    pyr0,                    # [H, W, 3] level-0 (I, dx, dy)
    gsq1,                    # [H/2, W/2] level-1 squared gradients
    gsq2,                    # [H/4, W/4] level-2 squared gradients
    num_want: int,
    block: int = 32,
    pot: int = 5,
    min_cut: float = 0.5,
    min_add: float = 7.0,
    down_weight: float = 0.75,
    seed: int = 0,
):
    """Select up to num_want candidate pixels; returns (uv [num_want, 2] f32,
    score [num_want], valid [num_want] bool), sorted by score descending.

    Mirrors PixelSelector::select's 3-scale cascade: a pixel wins its
    d-cell if its dithered directional gradient clears the level-0
    threshold; cells with no winner fall back to 2d cells at level 1
    (threshold x down_weight), then 4d at level 2."""
    h, w = pyr0.shape[0], pyr0.shape[1]
    g = pyr0[..., 1:3]
    gsq0 = jnp.sum(g * g, axis=-1)
    th0 = _block_quantile_threshold(gsq0, block, min_cut, min_add) ** 2

    dirs = _hash_dirs(h, w, pot, seed)
    iy = jnp.arange(h) // pot
    ix = jnp.arange(w) // pot
    d = dirs[iy[:, None], ix[None, :]]                             # [H, W, 2]
    dir_score0 = jnp.abs(jnp.sum(g * d, axis=-1)) ** 2             # dithered |∇I·dir|²

    score0 = jnp.where(gsq0 > th0, dir_score0 + gsq0, 0.0)
    win0 = _cell_argmax(score0, pot)

    # level-1 fallback: upsample level-1 gradients, threshold down-weighted
    gsq1_up = jnp.repeat(jnp.repeat(gsq1, 2, 0), 2, 1)[:h, :w]
    score1 = jnp.where(gsq1_up > th0 * down_weight ** 2, gsq1_up, 0.0)
    win1 = _cell_argmax(score1, 2 * pot)
    # only where the containing 2d-cell got no level-0 winner
    has0 = _cell_has_winner(win0, 2 * pot)
    win1 = win1 * (1.0 - has0)

    gsq2_up = jnp.repeat(jnp.repeat(gsq2, 4, 0), 4, 1)[:h, :w]
    score2 = jnp.where(gsq2_up > th0 * down_weight ** 4, gsq2_up, 0.0)
    win2 = _cell_argmax(score2, 4 * pot)
    has01 = _cell_has_winner(jnp.maximum(win0, win1), 4 * pot)
    win2 = win2 * (1.0 - has01)

    total = win0 * (score0 + 3e8) + win1 * (score1 + 2e8) + win2 * (score2 + 1e8)
    # border exclusion (pattern padding + interpolation margin)
    total = total.at[:4, :].set(0).at[-4:, :].set(0).at[:, :4].set(0).at[:, -4:].set(0)

    flat = total.reshape(-1)
    scores, idx = jax.lax.top_k(flat, num_want)
    vv = idx // w
    uu = idx % w
    uv = jnp.stack([uu, vv], axis=-1).astype(jnp.float32)
    valid = scores > 0
    return uv, scores, valid


def _cell_has_winner(win, cell: int):
    """[H, W] winner mask -> per-pixel flag: does my `cell`-cell contain a
    winner already?"""
    h, w = win.shape
    ch, cw = h // cell, w // cell
    s = win[: ch * cell, : cw * cell].reshape(ch, cell, cw, cell)
    has = (s.sum(axis=(1, 3)) > 0).astype(win.dtype)               # [ch, cw]
    up = jnp.repeat(jnp.repeat(has, cell, 0), cell, 1)
    out = jnp.zeros_like(win)
    return out.at[: ch * cell, : cw * cell].set(up)
