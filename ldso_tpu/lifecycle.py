"""Device-side keyframe lifecycle programs: activation + seed merge.

JAX redesign of the host surgery in the reference's
``makeKeyFrame`` (reference: n-lalanne/LDSO src/frontend/FullSystem.cc
activatePointsMT ~L500 and makeNewTraces ~L760): the round-3 engine
pulled a ~20-leaf bank+window snapshot to the host per keyframe, gated
and sorted candidates in numpy, and pushed the result back, waiting on
the device twice per keyframe. Here the ENTIRE candidate lifecycle is
two jitted device programs:

  * :func:`kf_activate` — activation GN (idepth refinement vs the whole
    window), quality/energy/Hessian gates, the occupancy-cell spacing
    gate, top-``n_want`` selection, and the scatter into free window
    point slots — one dispatch, no host in the loop. The host receives
    only a small stats vector (riding the later BA readback).
  * :func:`compute_seed_patch` — merges corner-biased and gradient
    candidates (reference: FeatureDetector + PixelSelector), dedups,
    assigns free bank slots after the keyframe's drops, and emits the
    arguments for :func:`ldso_tpu.core.bank.apply_patch` — so the patch
    is replayable by the bank-patch journal (lost-update safety under
    concurrent tracing).

The quadratic (N²) masks below are deliberate: 2048² boolean ops are
~4 MB of elementwise device work, cheaper than the host round trip they
replace.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ldso_tpu import trace as trace_mod
from ldso_tpu.config import LdsoConfig
from ldso_tpu.core.bank import Bank
from ldso_tpu.core.window import Window
from ldso_tpu.math import lie

_HI = jax.lax.Precision.HIGHEST

# layout of the kf_activate stats vector
ST_N_IMM = 0          # valid candidates in the bank
ST_N_IMM_GOOD = 1     # last trace GOOD
ST_N_IMM_Q = 2        # GOOD and above the quality gate
ST_N_ACT = 3          # activated into the window this KF
ST_N_CORNER_ACT = 4   # of those, corner-seeded
ST_N_ACTIVE = 5       # window active points AFTER activation
ST_LEN = 6


def _project_to_slot(T_all, c, uv, idepth, host_slot, slot):
    """Project host-frame pixels (uv, idepth, host) into window frame
    ``slot``; returns uv' [N,2] and a positive-depth mask."""
    fx, fy, cx, cy = c[0], c[1], c[2], c[3]
    T_rel = jnp.einsum("ij,pjk->pik", T_all[slot],
                       lie.se3_inverse(T_all)[host_slot], precision=_HI)
    xh = jnp.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy,
                    jnp.ones_like(uv[:, 0])], axis=-1)
    X = jnp.einsum("pij,pj->pi", T_rel[:, :3, :3], xh, precision=_HI) \
        + T_rel[:, :3, 3] * idepth[:, None]
    z = X[..., 2]
    ok = z > 1e-6
    zs = jnp.where(ok, z, 1.0)
    return jnp.stack([fx * X[..., 0] / zs + cx,
                      fy * X[..., 1] / zs + cy], axis=-1), ok


@functools.partial(jax.jit, static_argnames=("cfg",))
def kf_activate(win: Window, bank: Bank, intr, new_slot, mad_px, cfg):
    """Promote the best immature candidates to active window points.

    Reference behavior preserved (activatePointsMT + CoarseDistanceMap):
    candidates must be GOOD, high-quality, energy/Hessian-gated after an
    idepth GN against the whole window, spaced by an occupancy-cell gate
    in the NEW keyframe's image (radius ``mad_px``; the adaptive ladder
    that feeds mad_px stays on the host — it is sequential scalar state),
    then the best ``desired_point_density − n_active`` fill free window
    slots. Colors/weights come from the bank (sampled at seeding from
    the same host pixels — identical source to a re-sample).

    Returns (window', bank_drop_mask [N], stats [ST_LEN] f32).
    """
    T_all = win.current_pose()
    res = trace_mod.activate_candidates_device(
        win.images, win.frame_valid, T_all, win.x, win.exposure,
        bank, intr, float(cfg.trace.min_quality), iters=3,
        huber_th=float(cfg.ba.huber_th))
    can, d, Hd = res["can"], res["idepth"], res["H_dd"]
    E, cnt = res["energy"], res["count"]
    ok = can & (Hd > cfg.ba.min_idepth_hessian) & (cnt >= 8) \
        & (E < cfg.ba.outlier_th * jnp.maximum(cnt, 1))

    N = bank.capacity
    P = win.num_points
    # quality-descending order with gated-out rows last
    order = jnp.argsort(jnp.where(ok, -bank.quality, jnp.inf))
    ok_s = ok[order]
    uv_s = bank.uv[order]
    d_s = d[order]
    host_s = bank.host_slot[order].astype(jnp.int32)

    # occupancy-cell spacing gate in the new KF's image (reference:
    # CoarseDistanceMap; explicit cell hashing instead of BFS)
    cell = jnp.maximum(mad_px, 1.0)
    cand_uv, _ = _project_to_slot(T_all, win.c, uv_s, d_s, host_s, new_slot)
    act_uv, _ = _project_to_slot(T_all, win.c, win.p_uv, win.p_idepth,
                                 win.p_host, new_slot)

    def keys(uv):
        # int32-safe: cell coords are bounded by the image size / cell
        # (≤ 640), so a 2048 stride cannot collide or overflow
        cells = jnp.clip(jnp.floor(uv / cell), -1024, 1024).astype(jnp.int32)
        return cells[:, 0] * 2048 + cells[:, 1]

    ck = keys(cand_uv)
    ak = keys(act_uv)
    occupied = jnp.any((ck[:, None] == ak[None, :]) & win.p_valid[None, :],
                       axis=1)
    # first-occurrence-per-cell among gated candidates in quality order
    ii = jnp.arange(N)
    dup = jnp.any((ck[:, None] == ck[None, :]) & ok_s[None, :]
                  & (ii[None, :] < ii[:, None]), axis=1)
    # host ladder gates spacing off when mad < 0.25; mad_px = 2·mad
    spacing_on = mad_px >= 0.5
    keep = ok_s & (~(dup | occupied) | ~spacing_on)

    # top n_want into free window slots
    n_active = jnp.sum(win.p_valid)
    n_want = jnp.clip(jnp.int32(cfg.selector.desired_point_density)
                      - n_active, 0, P - n_active)
    rank = jnp.cumsum(keep) - 1
    chosen = keep & (rank < n_want)
    slot_order = jnp.argsort(win.p_valid)          # free slots first, ascending
    target = jnp.where(chosen, slot_order[jnp.clip(rank, 0, P - 1)], P)

    # scatter into the window (mode="drop" discards the P-padded rows)
    col_s = bank.color[order]
    wgt_s = bank.weight[order]
    idep = jnp.clip(d_s, 1e-5, 50.0)
    targets_mask = jnp.broadcast_to(win.frame_valid[None, :], (N, win.num_frames))
    res_rows = targets_mask & (jnp.arange(win.num_frames)[None, :]
                               != host_s[:, None])
    win2 = win._replace(
        p_valid=win.p_valid.at[target].set(True, mode="drop"),
        p_host=win.p_host.at[target].set(host_s, mode="drop"),
        p_uv=win.p_uv.at[target].set(uv_s, mode="drop"),
        p_color=win.p_color.at[target].set(col_s, mode="drop"),
        p_weight=win.p_weight.at[target].set(wgt_s, mode="drop"),
        p_idepth=win.p_idepth.at[target].set(idep, mode="drop"),
        p_idepth_zero=win.p_idepth_zero.at[target].set(idep, mode="drop"),
        res_mask=win.res_mask.at[target].set(res_rows, mode="drop"),
    )

    # bank drop mask back in UNSORTED order
    drop = jnp.zeros(N, bool).at[order].set(chosen)

    good = bank.valid & (bank.last_status == trace_mod.GOOD)
    stats = jnp.stack([
        jnp.sum(bank.valid), jnp.sum(good),
        jnp.sum(good & (bank.quality > cfg.trace.min_quality)),
        jnp.sum(chosen),
        jnp.sum(bank.is_corner[order] & chosen),
        n_active + jnp.sum(chosen),
    ]).astype(jnp.float32)
    return win2, drop, stats


@functools.partial(jax.jit, static_argnames=("cfg",))
def compute_seed_patch(bank: Bank, seed, host_slot, dying_mask, cfg):
    """Build apply_patch args for this keyframe's bank surgery entirely
    on device: drop candidates hosted by dying frames, merge corner +
    gradient seeds (corner-biased fraction, 2-px dedup — reference:
    makeNewTraces ordering), and assign free bank slots after the drops.

    ``seed`` is the _seed_program output dict (device arrays);
    ``dying_mask`` is a [F] bool of window slots being marginalized.
    Returns (drop_mask [N], slots [N], uv [N,2], color [N,8],
    weight [N,8], is_corner [N]) — pass directly to bank.apply_patch
    (slots padded with N = dropped)."""
    N = bank.capacity
    drop = bank.valid & dying_mask[bank.host_slot]
    valid_after = bank.valid & ~drop
    free_count = N - jnp.sum(valid_after)
    n_want = jnp.minimum(jnp.int32(cfg.selector.desired_immature_density),
                         free_count)

    has_corners = cfg.selector.corner_fraction > 0 and "corner_uv" in seed
    if has_corners:
        c_uv, c_score = seed["corner_uv"], seed["corner_score"]
        c_col, c_wgt = seed["corner_color"], seed["corner_weight"]
        # true FAST hits only (detect() marks them with a +1e3 offset)
        fv = seed["corner_valid"] & (c_score > 1e3)
        n_c = (n_want * cfg.selector.corner_fraction).astype(jnp.int32)
        c_acc = fv & (jnp.cumsum(fv) - 1 < n_c)
    s_uv, s_val = seed["sel_uv"], seed["sel_valid"]
    s_col, s_wgt = seed["sel_color"], seed["sel_weight"]
    if has_corners:
        # gradient picks within 2 px of an accepted corner are duplicates
        d2 = jnp.sum((s_uv[:, None, :] - c_uv[None, :, :]) ** 2, axis=-1)
        d2 = jnp.where(c_acc[None, :], d2, jnp.inf)
        s_keep = s_val & (jnp.min(d2, axis=1) > 4.0)
        uv = jnp.concatenate([c_uv, s_uv]).astype(jnp.float32)
        col = jnp.concatenate([c_col, s_col]).astype(jnp.float32)
        wgt = jnp.concatenate([c_wgt, s_wgt]).astype(jnp.float32)
        acc = jnp.concatenate([c_acc, s_keep])
        is_corner = jnp.concatenate([jnp.ones(c_uv.shape[0], bool),
                                     jnp.zeros(s_uv.shape[0], bool)])
    else:
        uv, col, wgt = (s_uv.astype(jnp.float32), s_col.astype(jnp.float32),
                        s_wgt.astype(jnp.float32))
        acc, is_corner = s_val, jnp.zeros(s_uv.shape[0], bool)

    rank = jnp.cumsum(acc) - 1
    take = acc & (rank < n_want)
    slot_order = jnp.argsort(valid_after)           # free slots first
    # COMPACT the accepted seeds into N rows by rank (the candidate list
    # is C+S rows and may exceed the bank capacity; truncating its head
    # instead of compacting starved the bank at small capacities)
    dest = jnp.where(take, rank, N).astype(jnp.int32)   # ≥N rows dropped
    out_slots = jnp.full((N,), N, jnp.int32).at[dest].set(
        slot_order[jnp.clip(rank, 0, N - 1)].astype(jnp.int32), mode="drop")
    out_uv = jnp.zeros((N, 2), jnp.float32).at[dest].set(uv, mode="drop")
    out_col = jnp.zeros((N, 8), jnp.float32).at[dest].set(col, mode="drop")
    out_wgt = jnp.ones((N, 8), jnp.float32).at[dest].set(wgt, mode="drop")
    out_corner = jnp.zeros((N,), bool).at[dest].set(is_corner, mode="drop")
    return (drop, out_slots, out_uv, out_col, out_wgt, out_corner)
