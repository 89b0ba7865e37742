"""Binary-descriptor matching as dense matmuls.

JAX redesign of the reference's ``FeatureMatcher``
(reference: n-lalanne/LDSO src/frontend/FeatureMatcher.cc — brute-force
Hamming with a ratio test, optionally bucketed by DBoW3 FeatureVector
nodes): with bits unpacked to {0,1} vectors, the full N×M Hamming
distance matrix is
    d(a, b) = Σa + Σb − 2·a·bᵀ
— one matmul instead of per-pair popcount loops. Mutual
nearest + Lowe ratio gating are elementwise postprocessing.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ldso_tpu.loop.orb import unpack_bits

_HI = jax.lax.Precision.HIGHEST


class Matches(NamedTuple):
    idx_b: jnp.ndarray      # i32 [N] best match in B for each A feature
    dist: jnp.ndarray       # f32 [N] Hamming distance of best match
    valid: jnp.ndarray      # bool [N] passed ratio + mutual + threshold


def hamming_matrix(desc_a: jnp.ndarray, desc_b: jnp.ndarray) -> jnp.ndarray:
    """u8 [N, 32] x u8 [M, 32] -> f32 [N, M] Hamming distances."""
    a = unpack_bits(desc_a)
    b = unpack_bits(desc_b)
    ab = jnp.matmul(a, b.T, precision=_HI)
    sa = jnp.sum(a, axis=-1, keepdims=True)
    sb = jnp.sum(b, axis=-1, keepdims=True)
    return sa + sb.T - 2.0 * ab


@functools.partial(jax.jit, static_argnames=())
def match(desc_a, valid_a, desc_b, valid_b,
          max_dist: float = 64.0, ratio: float = 0.75) -> Matches:
    """Mutual-nearest Hamming matching with Lowe ratio test
    (reference: FeatureMatcher::SearchBruteForce + DistanceThreshold)."""
    d = hamming_matrix(desc_a, desc_b)
    big = jnp.asarray(1e9, d.dtype)
    d = jnp.where(valid_a[:, None] & valid_b[None, :], d, big)

    best_b = jnp.argmin(d, axis=1)                               # [N]
    best_d = jnp.min(d, axis=1)
    # second best for ratio test
    d2 = d.at[jnp.arange(d.shape[0]), best_b].set(big)
    second_d = jnp.min(d2, axis=1)
    # mutual check
    best_a_of_b = jnp.argmin(d, axis=0)                          # [M]
    mutual = best_a_of_b[best_b] == jnp.arange(d.shape[0])

    ok = (best_d <= max_dist) & (best_d < ratio * second_d) & mutual & valid_a
    return Matches(idx_b=best_b.astype(jnp.int32), dist=best_d, valid=ok)
