"""Distributed global Sim(3) pose graph: edge-sharded LM/CG.

The reference optimizes the global pose graph single-threaded inside one
process (reference: n-lalanne/LDSO src/Map.cc::OptimizeALLKFs, g2o
SparseOptimizer on one CPU core); this module is the scaling
axis named in SURVEY.md §5.7/§5.8: the **edge list is sharded by
keyframe block** across the device mesh (edges sorted by their owning
vertex block → contiguous trajectory chunks per device, loop edges as
the cross-block halo), each device linearizes its edge shard locally
(the dominant cost — batched Sim3 Jacobians), and vertex-sized [K, 7]
vectors are reduced with `psum`. The conjugate-gradient matvec
is per-shard gather/scatter over local edges + one psum — the Hessian
[7K, 7K] is never materialized, and no device ever holds more than its
own edge shard.

Cost model: per LM iteration 1 psum of [K,7,7]+[K,7] (the block-Jacobi
preconditioner + gradient) and `cg_iters` psums of [K,7] — all tiny
(K=4096 → 112 KB) latency-bound collectives, while the O(E) edge
work parallelizes linearly. Identical semantics to
`ldso_tpu.loop.posegraph.optimize_pose_graph` (tested against it on the
virtual CPU mesh).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ldso_tpu.loop.posegraph import PGOResult, _edge_system, edge_residual
from ldso_tpu.math import lie

_HI = jax.lax.Precision.HIGHEST

AXIS = "kf"   # mesh axis name the edge list (KF blocks) is sharded over


def _local_energy(S, ei, ej, S_meas_inv, w_edge, huber):
    S_i, S_j = S[ei], S[ej]
    r = jax.vmap(edge_residual)(S_i, S_j, S_meas_inv)
    rn = jnp.linalg.norm(r, axis=-1)
    hw = jnp.where(rn < huber, 1.0, huber / jnp.maximum(rn, 1e-12))
    return jax.lax.psum(jnp.sum(w_edge * hw * rn * rn * (2.0 - hw)), AXIS)


def _pgo_shard(S_init, ei, ej, S_meas, w_edge, fixed, lam0,
               lm_iters: int, cg_iters: int, huber: float):
    """Runs per device inside shard_map. S_init/fixed replicated; the
    edge arrays are this device's shard. Returns replicated S + energy."""
    K = S_init.shape[0]
    S_meas_inv = lie.sim3_inverse(S_meas)
    free = ~fixed

    def lm_step(carry, _):
        S, lam, E_prev = carry
        r, Ji, Jj, omega = _edge_system(S, ei, ej, S_meas_inv, w_edge, huber)

        # local scatter-add of block-diagonal + gradient, ONE fused psum
        Hii = jnp.einsum("eab,e,eac->ebc", Ji, omega, Ji, precision=_HI)
        Hjj = jnp.einsum("eab,e,eac->ebc", Jj, omega, Jj, precision=_HI)
        diag_loc = jnp.zeros((K, 7, 7), S.dtype).at[ei].add(Hii).at[ej].add(Hjj)
        b_loc = (jnp.zeros((K, 7), S.dtype)
                 .at[ei].add(jnp.einsum("eab,e,ea->eb", Ji, omega, r,
                                        precision=_HI))
                 .at[ej].add(jnp.einsum("eab,e,ea->eb", Jj, omega, r,
                                        precision=_HI)))
        packed = jax.lax.psum(
            jnp.concatenate([diag_loc.reshape(K, 49), b_loc], axis=-1), AXIS)
        diag = packed[:, :49].reshape(K, 7, 7)
        b = jnp.where(free[:, None], packed[:, 49:], 0.0)

        damp = (lam * jnp.maximum(jax.vmap(jnp.trace)(diag) / 7.0, 1e-6)
                + 1e-8)                                            # [K]
        diag_d = diag + damp[:, None, None] * jnp.eye(7, dtype=S.dtype)
        diag_inv = jnp.linalg.inv(diag_d)

        def matvec(x):
            """(JᵀΩJ + λD)x: local edge gather/scatter + one psum."""
            u = (jnp.einsum("eab,eb->ea", Ji, x[ei], precision=_HI)
                 + jnp.einsum("eab,eb->ea", Jj, x[ej], precision=_HI))
            u = omega[:, None] * u
            y = (jnp.zeros_like(x)
                 .at[ei].add(jnp.einsum("eab,ea->eb", Ji, u, precision=_HI))
                 .at[ej].add(jnp.einsum("eab,ea->eb", Jj, u, precision=_HI)))
            y = jax.lax.psum(y, AXIS) + damp[:, None] * x
            return jnp.where(free[:, None], y, 0.0)

        def precond(x):
            return jnp.where(free[:, None],
                             jnp.einsum("kab,kb->ka", diag_inv, x,
                                        precision=_HI), 0.0)

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
        E_new = _local_energy(S_new, ei, ej, S_meas_inv, w_edge, huber)
        accept = E_new < E_prev
        S = jnp.where(accept, S_new, S)
        lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-7), lam * 4.0)
        E = jnp.where(accept, E_new, E_prev)
        return (S, lam, E), None

    E0 = _local_energy(S_init, ei, ej, S_meas_inv, w_edge, huber)
    (S, lam, E), _ = jax.lax.scan(lm_step, (S_init, lam0, E0), None,
                                  length=lm_iters)
    return S, E


def make_distributed_pgo(mesh: Mesh, lm_iters: int = 20, cg_iters: int = 60,
                         huber: float = 0.5):
    """Build the jitted multi-device pose-graph optimizer.

    Call signature of the returned fn:
      (S_init [K,4,4], ei [E], ej [E], S_meas [E,4,4], w_edge [E],
       fixed [K], lam0) -> PGOResult
    The edge arrays must have E divisible by the mesh size (pad with
    w_edge = 0 slots; `shard_edges` does this).
    """
    body = functools.partial(_pgo_shard, lm_iters=lm_iters,
                             cg_iters=cg_iters, huber=huber)
    sharded = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )

    @jax.jit
    def run(S_init, ei, ej, S_meas, w_edge, fixed, lam0=1e-4):
        S, E = sharded(S_init, ei, ej, S_meas, w_edge, fixed,
                       jnp.asarray(lam0, S_init.dtype))
        return PGOResult(S=S, energy=E, iterations=jnp.int32(lm_iters))

    return run


def shard_edges(ei, ej, S_meas, w_edge, mesh: Mesh, sort_by_block: bool = True):
    """Pad the edge list to a multiple of the mesh size, sort edges by
    their owning vertex (→ contiguous KF blocks per device), and place
    the shards on the mesh."""
    n = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    ei = np.asarray(ei)
    ej = np.asarray(ej)
    S_meas = np.asarray(S_meas)
    w_edge = np.asarray(w_edge)
    if sort_by_block:
        order = np.argsort(ei, kind="stable")
        ei, ej, S_meas, w_edge = ei[order], ej[order], S_meas[order], w_edge[order]
    E = len(ei)
    pad = (-E) % n
    if pad:
        ei = np.concatenate([ei, np.zeros(pad, ei.dtype)])
        ej = np.concatenate([ej, np.zeros(pad, ej.dtype)])
        S_meas = np.concatenate(
            [S_meas, np.tile(np.eye(4, dtype=S_meas.dtype), (pad, 1, 1))])
        w_edge = np.concatenate([w_edge, np.zeros(pad, w_edge.dtype)])
    sh = NamedSharding(mesh, P(AXIS))
    put = lambda x: jax.device_put(jnp.asarray(x), sh)
    return put(ei), put(ej), put(S_meas), put(w_edge)


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.asarray(devs[:n]), (AXIS,))


# ---------------------------------------------------------------------------
# Block-row-partitioned PGO with halo exchange (SURVEY §5.7/§5.8)
#
# The edge-sharded solver above psums REPLICATED [K,7] vectors every CG
# iteration — O(K) bytes per collective regardless of sharding (fine to
# K≈4k by its own cost model, not to "thousands of KFs per host block").
# Here the VERTEX states are block-row partitioned: each device owns a
# contiguous trajectory chunk of B=K/n keyframes plus the edges whose i
# endpoint it owns; only HALO rows — owned rows that other blocks' edges
# reference (block-boundary odometry neighbors + loop-edge endpoints) —
# are exchanged. Per CG iteration the collectives move n·H·7 floats
# (halo gather + reverse scatter) + 2 scalars; per LM iteration one
# n·H·16 pose-halo gather and one n·H·56 diag/gradient exchange. H is
# the cross-block degree — for a SLAM trajectory H ≪ B, so per-device
# traffic is proportional to the loop structure, not the map size.
# (The exchanges use all_gather/all_to_all on the halo buffers;
# payload ∝ halo either way.)


def partition_pose_graph(K: int, ei, ej, S_meas, w_edge, n_blocks: int):
    """Host-side graph partition: contiguous KF blocks, per-block edge
    lists (owned by the i endpoint), halo tables and encoded endpoint
    indices into [own block | gathered halo buffers]."""
    B = -(-K // n_blocks)
    Kp = B * n_blocks
    ei = np.asarray(ei, np.int64)
    ej = np.asarray(ej, np.int64)
    S_meas = np.asarray(S_meas, np.float32)
    w_edge = np.asarray(w_edge, np.float32)
    live = w_edge > 0
    owner_e = np.minimum(ei // B, n_blocks - 1)

    # rows each owner must EXPORT (referenced as a remote j endpoint)
    need: list = [set() for _ in range(n_blocks)]
    for e in np.flatnonzero(live):
        oj = min(int(ej[e]) // B, n_blocks - 1)
        if oj != owner_e[e]:
            need[oj].add(int(ej[e]))
    halo = [np.sort(np.asarray(sorted(v), np.int64)) for v in need]
    H = max(1, max((len(h) for h in halo), default=1))
    halo_out = np.zeros((n_blocks, H), np.int32)
    halo_mask = np.zeros((n_blocks, H), bool)
    halo_pos = [dict() for _ in range(n_blocks)]
    for d in range(n_blocks):
        for p, g in enumerate(halo[d]):
            halo_out[d, p] = int(g) - d * B
            halo_mask[d, p] = True
            halo_pos[d][int(g)] = p

    counts = [int((live & (owner_e == d)).sum()) for d in range(n_blocks)]
    E_max = max(1, max(counts))
    ei_enc = np.zeros((n_blocks, E_max), np.int32)
    ej_enc = np.zeros((n_blocks, E_max), np.int32)
    Sm = np.tile(np.eye(4, dtype=np.float32), (n_blocks, E_max, 1, 1))
    we = np.zeros((n_blocks, E_max), np.float32)
    fill = [0] * n_blocks
    for e in np.flatnonzero(live):
        d = int(owner_e[e])
        p = fill[d]
        fill[d] += 1
        ei_enc[d, p] = int(ei[e]) - d * B
        oj = min(int(ej[e]) // B, n_blocks - 1)
        if oj == d:
            ej_enc[d, p] = int(ej[e]) - d * B
        else:
            ej_enc[d, p] = B + oj * H + halo_pos[oj][int(ej[e])]
        Sm[d, p] = S_meas[e]
        we[d, p] = w_edge[e]
    return dict(B=B, H=H, Kp=Kp, n=n_blocks, ei=ei_enc, ej=ej_enc,
                S_meas=Sm, w=we, halo_out=halo_out, halo_mask=halo_mask)


def _block_pgo_shard(S_blk, fixed_blk, ei, ej, S_meas, w_edge,
                     halo_out, halo_mask, lam0,
                     n: int, B: int, H: int,
                     lm_iters: int, cg_iters: int, huber: float):
    """Per-device body (shard_map strips the leading device axis)."""
    dt = S_blk.dtype
    free = ~fixed_blk                                          # [B]
    S_meas_inv = lie.sim3_inverse(S_meas)
    mask_f = halo_mask.astype(dt)

    def halo_gather(x_blk):
        """[B, ...] -> [B + n·H, ...] (own rows | all blocks' halos)."""
        out = x_blk[halo_out] * mask_f.reshape(
            (H,) + (1,) * (x_blk.ndim - 1))
        allh = jax.lax.all_gather(out, AXIS)                   # [n, H, ...]
        return jnp.concatenate(
            [x_blk, allh.reshape((n * H,) + x_blk.shape[1:])])

    def halo_scatter_back(y_comb):
        """Return remote-row contributions to their owners and add."""
        y_loc = y_comb[:B]
        y_rem = y_comb[B:].reshape((n, H) + y_comb.shape[1:])
        recv = jax.lax.all_to_all(y_rem, AXIS, split_axis=0, concat_axis=0)
        contrib = jnp.sum(recv, axis=0) * mask_f.reshape(
            (H,) + (1,) * (y_comb.ndim - 1))
        return y_loc.at[halo_out].add(contrib)

    def local_energy(S_comb):
        S_i, S_j = S_comb[ei], S_comb[ej]
        r = jax.vmap(edge_residual)(S_i, S_j, S_meas_inv)
        rn = jnp.linalg.norm(r, axis=-1)
        hw = jnp.where(rn < huber, 1.0, huber / jnp.maximum(rn, 1e-12))
        return jax.lax.psum(jnp.sum(w_edge * hw * rn * rn * (2.0 - hw)),
                            AXIS)

    def lm_step(carry, _):
        S_blk, lam, E_prev = carry
        S_comb = halo_gather(S_blk)
        r, Ji, Jj, omega = _edge_system(S_comb, ei, ej, S_meas_inv,
                                        w_edge, huber)

        Hii = jnp.einsum("eab,e,eac->ebc", Ji, omega, Ji, precision=_HI)
        Hjj = jnp.einsum("eab,e,eac->ebc", Jj, omega, Jj, precision=_HI)
        bi = jnp.einsum("eab,e,ea->eb", Ji, omega, r, precision=_HI)
        bj = jnp.einsum("eab,e,ea->eb", Jj, omega, r, precision=_HI)
        packed = (jnp.zeros((B + n * H, 56), dt)
                  .at[ei].add(jnp.concatenate(
                      [Hii.reshape(-1, 49), bi], axis=-1))
                  .at[ej].add(jnp.concatenate(
                      [Hjj.reshape(-1, 49), bj], axis=-1)))
        packed = halo_scatter_back(packed)                     # [B, 56]
        diag = packed[:, :49].reshape(B, 7, 7)
        b = jnp.where(free[:, None], packed[:, 49:], 0.0)

        damp = (lam * jnp.maximum(jax.vmap(jnp.trace)(diag) / 7.0, 1e-6)
                + 1e-8)
        diag_inv = jnp.linalg.inv(
            diag + damp[:, None, None] * jnp.eye(7, dtype=dt))

        def matvec(x_blk):
            x_comb = halo_gather(x_blk)
            u = omega[:, None] * (
                jnp.einsum("eab,eb->ea", Ji, x_comb[ei], precision=_HI)
                + jnp.einsum("eab,eb->ea", Jj, x_comb[ej], precision=_HI))
            y = (jnp.zeros((B + n * H, 7), dt)
                 .at[ei].add(jnp.einsum("eab,ea->eb", Ji, u, precision=_HI))
                 .at[ej].add(jnp.einsum("eab,ea->eb", Jj, u, precision=_HI)))
            y = halo_scatter_back(y) + damp[:, None] * x_blk
            return jnp.where(free[:, None], y, 0.0)

        def precond(x):
            return jnp.where(free[:, None],
                             jnp.einsum("kab,kb->ka", diag_inv, x,
                                        precision=_HI), 0.0)

        def pdot(a, b_):
            return jax.lax.psum(jnp.sum(a * b_), AXIS)

        x0 = jnp.zeros((B, 7), dt)
        r0 = -b - matvec(x0)
        z0 = precond(r0)

        def cg_body(c, _):
            x, rr, zz, p = c
            Ap = matvec(p)
            rz = pdot(rr, zz)
            alpha = rz / jnp.maximum(pdot(p, Ap), 1e-20)
            x = x + alpha * p
            rr2 = rr - alpha * Ap
            zz2 = precond(rr2)
            beta = pdot(rr2, zz2) / jnp.maximum(rz, 1e-20)
            return (x, rr2, zz2, zz2 + beta * p), None

        (dx, _, _, _), _ = jax.lax.scan(cg_body, (x0, r0, z0, z0), None,
                                        length=cg_iters)
        dx = jnp.where(free[:, None], dx, 0.0)

        S_new = lie.sim3_mul(lie.sim3_exp(dx), S_blk)
        E_new = local_energy(halo_gather(S_new))
        accept = E_new < E_prev
        S_blk = jnp.where(accept, S_new, S_blk)
        lam = jnp.where(accept, jnp.maximum(lam * 0.5, 1e-7), lam * 4.0)
        E = jnp.where(accept, E_new, E_prev)
        return (S_blk, lam, E), None

    E0 = local_energy(halo_gather(S_blk))
    (S_blk, lam, E), _ = jax.lax.scan(lm_step, (S_blk, lam0, E0), None,
                                      length=lm_iters)
    return S_blk, E


def make_block_pgo(mesh: Mesh, part: dict, lm_iters: int = 20,
                   cg_iters: int = 60, huber: float = 0.5):
    """Build the jitted block-partitioned optimizer for one partition.

    Call: (S_init [Kp,4,4] f32, fixed [Kp] bool, lam0) -> (S [Kp,4,4], E).
    The partition's static sizes (B, H, E_max) bake into the program —
    repartition + rebuild when the graph grows past the padded caps."""
    n, B, H = part["n"], part["B"], part["H"]
    body = functools.partial(_block_pgo_shard, n=n, B=B, H=H,
                             lm_iters=lm_iters, cg_iters=cg_iters,
                             huber=huber)
    sharded = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS),
                  P(AXIS), P(AXIS), P()),
        out_specs=(P(AXIS), P()),
        check_vma=False,
    )
    ei = jnp.asarray(part["ei"].reshape(-1))
    ej = jnp.asarray(part["ej"].reshape(-1))
    Sm = jnp.asarray(part["S_meas"].reshape(-1, 4, 4))
    we = jnp.asarray(part["w"].reshape(-1))
    halo_out = jnp.asarray(part["halo_out"].reshape(-1))
    halo_mask = jnp.asarray(part["halo_mask"].reshape(-1))

    @jax.jit
    def run(S_init, fixed, lam0=1e-4):
        S, E = sharded(S_init, fixed, ei, ej, Sm, we, halo_out, halo_mask,
                       jnp.asarray(lam0, S_init.dtype))
        return PGOResult(S=S, energy=E, iterations=jnp.int32(lm_iters))

    return run
