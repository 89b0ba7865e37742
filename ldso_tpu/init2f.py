"""Monocular bootstrap: two-frame coarse initialization.

JAX redesign of the reference's ``CoarseInitializer``
(reference: n-lalanne/LDSO src/frontend/CoarseInitializer.cc): joint
coarse-to-fine Gauss-Newton over the relative pose + affine (8 dof) AND
all per-point inverse depths, with
  * the α-prior that pulls inverse depths to 1 and translation to 0
    until parallax "snaps" (alphaW/alphaK machinery of calcResAndGS),
  * after the snap, a neighbor-coupling prior (couplingWeight) toward a
    smoothed depth field ``iR``,
  * inter-iteration regularization pulling ``iR`` to the neighbor median
    (optReg).

Structural deviation from the reference (deliberate): one point set
selected at level 0 and projected at every pyramid level (scaled
coordinates, per-level host colors), instead of per-level point sets
with parent pointers — same math, static shapes. The k-NN graph comes
from scipy's cKDTree on host, once (reference: makeNN/nanoflann).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ldso_tpu import select
from ldso_tpu.cameras import level_intrinsics
from ldso_tpu.config import LdsoConfig
from ldso_tpu.core.window import PATTERN_OFFSETS
from ldso_tpu.kernels.interp import bilinear, bilinear33, in_bounds
from ldso_tpu.math import lie

_HI = jax.lax.Precision.HIGHEST


class InitLevelOut(NamedTuple):
    T: jnp.ndarray
    ab: jnp.ndarray
    idepth: jnp.ndarray
    iR: jnp.ndarray
    good: jnp.ndarray
    energy: jnp.ndarray
    t_norm_sq: jnp.ndarray
    n_good: jnp.ndarray


@functools.partial(jax.jit, static_argnames=("iters", "level"))
def init_level(
    img3_new,               # [H_l, W_l, 3] new-frame pyramid level
    uv,                     # [N, 2] level-0 coords of points
    colors,                 # [N, 8] host colors at this level's scale
    neighbors,              # [N, K] neighbor indices
    T0, ab0,                # initial relative pose/affine
    idepth0, iR0, good0,    # per-point state
    intr0,                  # [4] level-0 intrinsics
    level: int,
    iters: int,
    snapped: bool,
    alpha_w: float = 150.0 * 150.0,
    alpha_k: float = 2.5e5,
    coupling: float = 1.0,
    reg_weight: float = 0.8,
    huber_th: float = 9.0,
):
    """GN iterations at one pyramid level (reference: trackFrame's loop
    over calcResAndGS / doStep / optReg)."""
    h, w = img3_new.shape[0], img3_new.shape[1]
    s = 0.5 ** level
    uv_l = uv * s + (0.5 * s - 0.5)
    intr_l = level_intrinsics(intr0, level)
    fx, fy, cx, cy = intr_l[0], intr_l[1], intr_l[2], intr_l[3]
    pat = jnp.asarray(PATTERN_OFFSETS)
    uvp = uv_l[:, None, :] + pat[None]                            # [N, 8, 2]
    xh = jnp.stack([(uvp[..., 0] - cx) / fx, (uvp[..., 1] - cy) / fy,
                    jnp.ones_like(uvp[..., 0])], axis=-1)

    def system(T, ab, d, iR, good):
        R, t = T[:3, :3], T[:3, 3]
        X = jnp.einsum("ij,pkj->pki", R, xh, precision=_HI) + t[None, None, :] * d[:, None, None]
        z = X[..., 2]
        okz = z > 1e-6
        zs = jnp.where(okz, z, 1.0)
        up, vp = X[..., 0] / zs, X[..., 1] / zs
        uvn = jnp.stack([fx * up + cx, fy * vp + cy], axis=-1)
        inb = in_bounds(uvn, w, h, 2.0) & okz
        hit = bilinear33(img3_new, uvn)
        r = hit[..., 0] - jnp.exp(ab[0]) * colors - ab[1]
        abs_r = jnp.abs(r)
        hw = jnp.where(abs_r < huber_th, 1.0, huber_th / jnp.maximum(abs_r, 1e-12))
        om = jnp.where(inb & good[:, None], hw, 0.0)

        # point considered good this round if most pattern samples landed
        pt_ok = jnp.sum(inb, axis=-1) >= 6
        e_pt = jnp.sum(jnp.where(inb, hw * r * r * (2.0 - hw), 0.0), axis=-1)

        g = hit[..., 1:3]
        new_id = d[:, None] / zs
        zeros = jnp.zeros_like(up)
        Jp_u = jnp.stack([new_id * fx, zeros, -new_id * up * fx,
                          -up * vp * fx, (1 + up * up) * fx, -vp * fx], axis=-1)
        Jp_v = jnp.stack([zeros, new_id * fy, -new_id * vp * fy,
                          -(1 + vp * vp) * fy, up * vp * fy, up * fy], axis=-1)
        J_pose = g[..., 0:1] * Jp_u + g[..., 1:2] * Jp_v           # [N, 8, 6]
        J_a = (-jnp.exp(ab[0]) * colors)[..., None]
        J_b = -jnp.ones_like(colors)[..., None]
        Jx = jnp.concatenate([J_pose, J_a, J_b], axis=-1)          # [N, 8, 8]
        dre = 1.0 / zs
        Jd = (g[..., 0] * (fx * dre * (t[0] - t[2] * up))
              + g[..., 1] * (fy * dre * (t[1] - t[2] * vp)))       # [N, 8]

        H = jnp.einsum("pki,pk,pkj->ij", Jx, om, Jx, precision=_HI)
        b = jnp.einsum("pki,pk->i", Jx, om * r, precision=_HI)
        Hxd = jnp.einsum("pki,pk->pi", Jx, om * Jd, precision=_HI) # [N, 8]
        Hdd = jnp.sum(om * Jd * Jd, axis=-1)
        bd = jnp.sum(om * Jd * r, axis=-1)
        E = jnp.sum(jnp.where(good[:, None], om * r * r * (2.0 - hw), 0.0))

        # α-prior / coupling prior (reference: alphaOpt switching).
        # `snapped` is a TRACED bool so the pre/post-snap variants share
        # ONE compiled program (the static-arg split doubled the
        # initializer's compile time)
        n_pts = jnp.maximum(jnp.sum(good), 1)
        Hdd = Hdd + jnp.where(snapped, coupling, alpha_w)
        bd = bd + jnp.where(snapped, coupling * (d - iR),
                            alpha_w * (d - 1.0))
        H = H.at[jnp.arange(3), jnp.arange(3)].add(
            jnp.where(snapped, 0.0, alpha_w * n_pts))
        b = b.at[:3].add(jnp.where(snapped, 0.0, alpha_w) * t * n_pts)
        return H, b, Hxd, Hdd, bd, E, pt_ok, e_pt

    def body(carry, _):
        """ONE system evaluation per iteration: the current state's GN
        system rides in the carry (same restructure as tracker.track_level
        — the previous evaluate-twice form doubled both the gather traffic
        and the compiled program size)."""
        T, ab, d, iR, good, lam, sysc = carry
        H, b, Hxd, Hdd, bd, E, pt_ok, e_pt = sysc
        inv_dd = 1.0 / (Hdd * (1.0 + lam) + 1e-10)
        H_sc = jnp.einsum("pi,p,pj->ij", Hxd, inv_dd, Hxd, precision=_HI)
        b_sc = jnp.einsum("pi,p->i", Hxd, inv_dd * bd, precision=_HI)
        Hf = H.at[jnp.arange(8), jnp.arange(8)].multiply(1.0 + lam) - H_sc
        Hf = Hf + 1e-6 * jnp.eye(8, dtype=H.dtype) * jnp.maximum(jnp.trace(H), 1.0)
        bf = b - b_sc
        dx = -jnp.linalg.solve(Hf, bf)
        dd = -(bd + jnp.matmul(Hxd, dx, precision=_HI)) * inv_dd
        T_new = lie.se3_mul(lie.se3_exp(dx[:6]), T)
        ab_new = ab + dx[6:8]
        d_new = jnp.clip(d + dd, 1e-3, 50.0)
        # regularization toward neighbor median (reference: optReg)
        nbr_iR = iR[neighbors]                                     # [N, K]
        med = jnp.median(nbr_iR, axis=-1)
        iR_new = (1.0 - reg_weight) * d_new + reg_weight * med
        good_new = good & pt_ok
        sys2 = system(T_new, ab_new, d_new, iR_new, good_new)
        accept = sys2[5] < E
        T = jnp.where(accept, T_new, T).astype(T.dtype)
        ab = jnp.where(accept, ab_new, ab).astype(ab.dtype)
        d = jnp.where(accept, d_new, d).astype(d.dtype)
        iR = jnp.where(accept, iR_new, iR).astype(iR.dtype)
        good = jnp.where(accept, good_new, good)
        sysc = jax.tree.map(lambda a_, b_: jnp.where(accept, b_, a_), sysc, sys2)
        lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-5), lam * 4.0).astype(lam.dtype)
        return (T, ab, d, iR, good, lam, sysc), None

    lam0 = jnp.asarray(0.1, T0.dtype)
    sys0 = system(T0, ab0, idepth0, iR0, good0)
    (T, ab, d, iR, good, lam, sysc), _ = jax.lax.scan(
        body, (T0, ab0, idepth0, iR0, good0, lam0, sys0), None, length=iters)
    H, b, Hxd, Hdd, bd, E, pt_ok, e_pt = sysc
    t_norm_sq = jnp.sum(T[:3, 3] ** 2)
    return InitLevelOut(T=T, ab=ab, idepth=d, iR=iR, good=good & pt_ok,
                        energy=E, t_norm_sq=t_norm_sq,
                        n_good=jnp.sum(good & pt_ok))


class CoarseInitializer:
    """Host-side conductor for the bootstrap (reference: setFirst/trackFrame
    + FullSystem's initializer path)."""

    def __init__(self, cfg: LdsoConfig, intr):
        self.cfg = cfg
        self.intr = jnp.asarray(intr, jnp.float32)
        self.frame_id_first: Optional[int] = None
        self.snapped = False
        self.snapped_at = -1
        self.frames_tracked = 0

    def set_first(self, pyr, gsq):
        """Select bootstrap points on the first frame."""
        cfg = self.cfg
        n = cfg.shapes.init_points
        uv, scores, valid = select.select_pixels(
            pyr[0], gsq[1], gsq[2], num_want=n,
            block=cfg.selector.block, pot=5,
            min_cut=cfg.selector.min_grad_hist_cut,
            min_add=cfg.selector.min_grad_hist_add,
        )
        self.uv = uv
        self.valid0 = valid
        pat = jnp.asarray(PATTERN_OFFSETS)
        self.colors = []  # per level host colors
        for l in range(cfg.shapes.pyr_levels):
            s = 0.5 ** l
            uv_l = uv * s + (0.5 * s - 0.5)
            self.colors.append(bilinear(pyr[l][..., 0], uv_l[:, None, :] + pat[None]))
        # neighbor graph (host, once)
        from scipy.spatial import cKDTree

        pts = np.asarray(uv)
        k = cfg.shapes.init_neighbors
        tree = cKDTree(pts)
        _, nbr = tree.query(pts, k=k + 1)
        self.neighbors = jnp.asarray(nbr[:, 1:].astype(np.int32))
        self.idepth = jnp.ones(n, jnp.float32)
        self.iR = jnp.ones(n, jnp.float32)
        self.good = np.asarray(valid)
        self.T = jnp.eye(4, dtype=jnp.float32)
        self.ab = jnp.zeros(2, jnp.float32)
        self.pyr_first = pyr
        self.frames_tracked = 0
        self.snapped = False
        self.snapped_at = -1

    def track(self, pyr_new) -> dict:
        """Track a new frame against the first; returns status dict.
        (reference: CoarseInitializer::trackFrame + FullSystem init path)"""
        cfg = self.cfg
        L = cfg.shapes.pyr_levels
        T, ab = self.T, self.ab
        # points get a fresh chance every frame (reference: isGood reset in
        # trackFrame); they are culled per level within this call only
        d, iR, good = self.idepth, self.iR, jnp.asarray(np.asarray(self.valid0))
        if not self.snapped:
            # until parallax snaps, translation and the depth field restart
            # from scratch each frame (reference: trackFrame's pre-snap
            # reset of thisToNext.translation() and idepth/iR) — pre-snap
            # bias must not accumulate
            T = T.at[:3, 3].set(0.0)
            d = jnp.ones_like(d)
            iR = jnp.ones_like(iR)
        out = None
        for l in range(L - 1, -1, -1):
            out = init_level(
                pyr_new[l], self.uv, self.colors[l], self.neighbors,
                T, ab, d, iR, good, self.intr,
                level=l, iters=int(cfg.init.max_iterations[min(l, len(cfg.init.max_iterations) - 1)]),
                snapped=self.snapped,
                alpha_w=cfg.init.alpha_w, alpha_k=cfg.init.alpha_k,
                coupling=cfg.init.coupling_weight, reg_weight=cfg.init.reg_weight,
                huber_th=cfg.init.huber_th,
            )
            T, ab, d, iR, good = out.T, out.ab, out.idepth, out.iR, out.good

        self.T, self.ab = T, ab
        self.idepth, self.iR = d, iR
        self.good = np.asarray(out.good)
        self.frames_tracked += 1

        # snap test (reference: alphaEnergy > alphaK·npts; the idepth-spread
        # accumulator EAlpha is dead code upstream — translation norm decides)
        n_good = max(int(out.n_good), 1)
        alpha_energy = cfg.init.alpha_w * float(out.t_norm_sq) * n_good
        if not self.snapped and alpha_energy > cfg.init.alpha_k * n_good:
            self.snapped = True
            self.snapped_at = self.frames_tracked
        done = self.snapped and (
            self.frames_tracked >= self.snapped_at + cfg.init.min_snap_frames)
        return dict(
            snapped=self.snapped, done=done,
            n_good=int(out.n_good), energy=float(out.energy),
            t_norm=float(np.sqrt(max(out.t_norm_sq, 0.0))),
        )

    def results(self):
        """Final bootstrap output, rescaled to mean inverse depth 1
        (reference: FullSystem::initializeFromInitializer)."""
        good = np.asarray(self.good) & np.asarray(self.idepth > 0)
        d = np.asarray(self.iR)
        mean_id = float(np.mean(d[good])) if good.any() else 1.0
        rescale = 1.0 / max(mean_id, 1e-6)
        T = np.asarray(self.T, dtype=np.float64)
        # idepth *= rescale shrinks the world by 1/rescale, so the baseline
        # must shrink too (reference: firstToNew.translation() /= rescaleFactor)
        T[:3, 3] /= rescale
        return dict(
            T_first_to_new=T,
            uv=np.asarray(self.uv),
            idepth=d * rescale,
            good=good,
            ab=np.asarray(self.ab),
            rescale=rescale,
        )
