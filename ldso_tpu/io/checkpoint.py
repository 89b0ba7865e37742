"""Checkpoint / resume of the full engine state.

The reference has NO checkpointing (SURVEY.md §5.4 — run-to-completion,
only the final trajectory export); this is a new capability this
framework adds: because the entire engine state is explicit data — the
Window pytree, the dense marginalization prior HM/bM, the immature
bank, host records (keyframes, frames, pose edges) — a checkpoint is a
single `.npz` plus a JSON sidecar, and resume reconstructs a
bit-identical conductor mid-sequence. Used by the consistency tests
(energy continuity across save/load) and for fault recovery on long
sequences.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Tuple

import jax.numpy as jnp
import numpy as np


def save_checkpoint(system, path: str) -> None:
    """Serialize a FullSystem to `<path>.npz` + `<path>.json`.

    Host registries (kfs, frames, pose_edges, map_points) are mutated by
    the async mapping/loop threads; snapshot them under state_lock so a
    mid-run checkpoint never sees a torn map or a dict resized during
    iteration."""
    arrays = {}
    # window pytree
    for name, val in system.win._asdict().items():
        arrays[f"win_{name}"] = np.asarray(val)
    if hasattr(system, "_materialize_prior"):
        system._materialize_prior()     # flush deferred marginalization folds
    arrays["HM"] = system.HM
    arrays["bM"] = system.bM
    bank = system.immatures
    from ldso_tpu.core.bank import Bank as _Bank
    for f in _Bank._fields:
        arrays[f"imm_{f}"] = getattr(bank, f)
    if system.T_last_cw is not None:
        arrays["T_last_cw"] = system.T_last_cw
    if system.T_prelast_cw is not None:
        arrays["T_prelast_cw"] = system.T_prelast_cw
    arrays["last_rel_ab"] = system.last_rel_ab
    with system.state_lock:
        kfs_snap = {k: (v, np.asarray(v.T_cw).copy(),
                        None if v.S_cw_opti is None
                        else np.asarray(v.S_cw_opti).copy())
                    for k, v in system.kfs.items()}
        frames_snap = list(system.frames)
        edges_snap = list(system.pose_edges)
        map_snap = {k: (d["xyz_cam"].copy(), d["color"].copy())
                    for k, d in system.map_points.items()}
    kfs = {
        str(k): dict(kf_id=v.kf_id, frame_id=v.frame_id, timestamp=v.timestamp,
                     slot=v.slot, in_window=v.in_window)
        for k, (v, _, _) in kfs_snap.items()
    }
    for k, (_, T_cw, S_opti) in kfs_snap.items():
        arrays[f"kf_T_{k}"] = T_cw
        if S_opti is not None:
            arrays[f"kf_S_{k}"] = S_opti
    frames = [dict(frame_id=f.frame_id, timestamp=f.timestamp, ref_kf=f.ref_kf,
                   is_kf=f.is_kf) for f in frames_snap]
    for i, f in enumerate(frames_snap):
        arrays[f"fr_T_{i}"] = f.T_from_ref
    edges = [dict(kf_a=e.kf_a, kf_b=e.kf_b, kind=e.kind, scale=e.scale)
             for e in edges_snap]
    for i, e in enumerate(edges_snap):
        arrays[f"edge_T_{i}"] = e.T_ab
    # persistent global map + PGO-optimized Sim3 poses
    for k, (xyz, col) in map_snap.items():
        arrays[f"map_xyz_{k}"] = xyz
        arrays[f"map_col_{k}"] = col

    meta = dict(
        kfs=kfs, frames=frames, edges=edges,
        slot_kf=[(-1 if s is None else s) for s in system.slot_kf],
        next_kf_id=system.next_kf_id, frame_count=system.frame_count,
        initialized=system.initialized, is_lost=system.is_lost,
        ref_kf=system.ref_kf, first_coarse_rmse=system.first_coarse_rmse,
        w=system.w, h=system.h, intr=[float(x) for x in system.intr],
        has_T_last="T_last_cw" in arrays, has_T_prelast="T_prelast_cw" in arrays,
    )
    np.savez_compressed(path + ".npz", **arrays)
    with open(path + ".json", "w") as f:
        json.dump(meta, f)


def load_checkpoint(path: str, cfg) -> "FullSystem":
    """Reconstruct a FullSystem from a checkpoint (inverse of save)."""
    from ldso_tpu.core.window import Window
    from ldso_tpu.system import FrameRecord, FullSystem, KeyframeRecord, PoseEdge
    from ldso_tpu import tracker

    with open(path + ".json") as f:
        meta = json.load(f)
    data = np.load(path + ".npz")

    system = FullSystem(cfg, np.asarray(meta["intr"], np.float32),
                        meta["w"], meta["h"])
    win_fields = {name: jnp.asarray(data[f"win_{name}"])
                  for name in Window._fields}
    system.win = Window(**win_fields)
    system.HM = data["HM"]
    system.bM = data["bM"]
    bank = system.immatures     # host snapshot of the device bank
    from ldso_tpu.core.bank import Bank as _Bank
    for fld in _Bank._fields:
        if f"imm_{fld}" in data:      # older checkpoints may miss new fields
            setattr(bank, fld, data[f"imm_{fld}"])
    from ldso_tpu.core import bank as bank_mod
    system.bank = bank_mod.from_host(bank)
    system.slot_kf = [None if s < 0 else s for s in meta["slot_kf"]]
    system.kfs = {}
    for k, v in meta["kfs"].items():
        system.kfs[int(k)] = KeyframeRecord(
            kf_id=v["kf_id"], frame_id=v["frame_id"], timestamp=v["timestamp"],
            T_cw=data[f"kf_T_{k}"], slot=v["slot"], in_window=v["in_window"],
            S_cw_opti=data[f"kf_S_{k}"] if f"kf_S_{k}" in data else None)
    system.map_points = {
        int(k[len("map_xyz_"):]): dict(xyz_cam=data[k],
                                       color=data["map_col_"
                                                  + k[len("map_xyz_"):]])
        for k in data.files if k.startswith("map_xyz_")}
    system.frames = [
        FrameRecord(f["frame_id"], f["timestamp"], f["ref_kf"],
                    data[f"fr_T_{i}"], f["is_kf"])
        for i, f in enumerate(meta["frames"])
    ]
    system.pose_edges = [
        PoseEdge(e["kf_a"], e["kf_b"], data[f"edge_T_{i}"], e["kind"], e["scale"])
        for i, e in enumerate(meta["edges"])
    ]
    system.next_kf_id = meta["next_kf_id"]
    system.frame_count = meta["frame_count"]
    system.initialized = meta["initialized"]
    system.is_lost = meta["is_lost"]
    system.ref_kf = meta["ref_kf"]
    system.first_coarse_rmse = meta["first_coarse_rmse"]
    system.last_rel_ab = data["last_rel_ab"]
    if meta["has_T_last"]:
        system.T_last_cw = data["T_last_cw"]
    if meta["has_T_prelast"]:
        system.T_prelast_cw = data["T_prelast_cw"]
    if system.initialized and system.ref_kf is not None:
        system._update_tracker_ref(system.kfs[system.ref_kf])
        system.last_rel_ab = data["last_rel_ab"]
        # rebuild the device-side constant-velocity prediction pair from
        # the restored trajectory state (a hard sync point — the live
        # system carries this on device and never re-derives it)
        system._resync_prediction(system._T_ref_cw_np)
    return system
