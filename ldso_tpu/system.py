"""System orchestration: the full odometry pipeline conductor.

JAX redesign of the reference's ``FullSystem``
(reference: n-lalanne/LDSO src/frontend/FullSystem.cc, SURVEY.md §3):
a functional core / imperative shell split — every numeric stage
(pyramid, tracking, tracing, activation, BA, marginalization assembly)
is a jitted device program over static-shape pytrees; this module is the
thin host state machine that owns the frame loop, the keyframe decision,
the point lifecycle (immature → active → marginalized/dropped), window
management, and trajectory bookkeeping.

Pipeline per frame (mirrors FullSystem::addActiveFrame → makeKeyFrame):
  pyramid → coarse track vs. reference KF → KF decision →
  [non-KF] epipolar trace of immature points
  [KF]     trace → flag marginalization victims → insert KF →
           activate immature points → windowed photometric BA →
           marginalize points+frames into the dense prior →
           select new candidates → rebuild tracker reference.

Host↔device discipline: ≤2 scalar readbacks per non-KF frame (track
diagnostics), a handful per KF (BA stats, activation gates).
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import json
import threading
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ldso_tpu import frame_step, lifecycle, select, tracker, trace as trace_mod
from ldso_tpu.ba import marginal, solve
from ldso_tpu.ba.residuals import assemble
from ldso_tpu.config import LdsoConfig
from ldso_tpu.core import bank as bank_mod
from ldso_tpu.core import window as win_mod
from ldso_tpu.core.bank import HostBank
from ldso_tpu.core.window import PATTERN_OFFSETS, Window
from ldso_tpu.init2f import CoarseInitializer
from ldso_tpu.kernels.interp import bilinear33, in_bounds
from ldso_tpu.kernels.pyramid import build_pyramid, crop_to_multiple
from ldso_tpu.math import lie

_HI = jax.lax.Precision.HIGHEST


# ---------------------------------------------------------------------------
# Jitted helpers
# ---------------------------------------------------------------------------


@jax.jit
def _project_points_to_slot(win: Window, slot):
    """Project every active point into window slot `slot`'s frame.

    Returns (uv' [P,2], idepth' [P], color' [P], valid [P]) — the
    semi-dense reference map for the coarse tracker (reference:
    CoarseTracker::makeCoarseDepthL0)."""
    T = win.current_pose()                                      # [F,4,4]
    T_slot = T[slot]
    T_host_inv = lie.se3_inverse(T)[win.p_host]                 # [P,4,4]
    T_rel = jnp.einsum("ij,pjk->pik", T_slot, T_host_inv, precision=_HI)
    fx, fy, cx, cy = win.c[0], win.c[1], win.c[2], win.c[3]
    xh = jnp.stack([(win.p_uv[:, 0] - cx) / fx, (win.p_uv[:, 1] - cy) / fy,
                    jnp.ones_like(win.p_uv[:, 0])], axis=-1)
    X = jnp.einsum("pij,pj->pi", T_rel[:, :3, :3], xh, precision=_HI) \
        + T_rel[:, :3, 3] * win.p_idepth[:, None]
    z = X[..., 2]
    okz = z > 1e-6
    zs = jnp.where(okz, z, 1.0)
    uvn = jnp.stack([fx * X[..., 0] / zs + cx, fy * X[..., 1] / zs + cy], axis=-1)
    h, w = win.images.shape[1], win.images.shape[2]
    inb = in_bounds(uvn, w, h, 3.0)
    # residual-less points are outliers awaiting the deferred drop — a
    # tracker ref built from the post-BA window (before _finish_kf's
    # drop_points) must exclude them or they drag the alignment
    valid = win.p_valid & okz & inb & (win.p_host != slot) \
        & jnp.any(win.res_mask, axis=-1)
    color = bilinear33(win.images[slot], uvn)[..., 0]
    idep = win.p_idepth / zs
    return uvn, idep, color, valid


@jax.jit
def _reexpress_jit(T_last, T_prelast, T_oldref, T_newref):
    D = lie.se3_mul(T_oldref, lie.se3_inverse(T_newref))
    return lie.se3_mul(T_last, D), lie.se3_mul(T_prelast, D)


@functools.partial(jax.jit, static_argnames=("outlier_sum",))
def _sample_pattern(img3, uv, outlier_sum: float = 2500.0):
    """Host-pattern colors + static gradient weights for new points
    (reference: PointHessian ctor color/weights)."""
    pat = jnp.asarray(PATTERN_OFFSETS)
    hit = bilinear33(img3, uv[:, None, :] + pat[None])          # [N,8,3]
    color = hit[..., 0]
    gsq = jnp.sum(hit[..., 1:3] ** 2, axis=-1)
    weight = jnp.sqrt(outlier_sum / (outlier_sum + gsq))
    return color, weight


@functools.partial(jax.jit, static_argnames=("cfg",))
def _seed_program(pyr0, pyr1, pyr2, cfg, seed):
    """Candidate-seeding device program: corner detection + gradient
    selection + 8-pattern color/weight sampling for BOTH pools, fused
    into ONE dispatch with ONE packed readback (reference:
    makeNewTraces = FeatureDetector + PixelSelector + ImmaturePoint
    ctors — each a separate host call there)."""
    gsq1 = jnp.sum(pyr1[..., 1:3] ** 2, axis=-1)
    gsq2 = jnp.sum(pyr2[..., 1:3] ** 2, axis=-1)
    osum = float(cfg.ba.outlier_th_sum_component)
    out = {}
    if cfg.selector.corner_fraction > 0:
        from ldso_tpu.loop import orb

        feats = orb.detect(pyr0, max_features=cfg.loop.max_features,
                           fast_th=cfg.loop.orb_fast_th)
        c_color, c_weight = _sample_pattern(pyr0, feats.uv, outlier_sum=osum)
        out.update(corner_uv=feats.uv, corner_score=feats.score,
                   corner_valid=feats.valid, corner_color=c_color,
                   corner_weight=c_weight)
    uv, scores, valid = select.select_pixels(
        pyr0, gsq1, gsq2,
        num_want=int(cfg.selector.desired_immature_density),
        block=cfg.selector.block, pot=5,
        min_cut=cfg.selector.min_grad_hist_cut,
        min_add=cfg.selector.min_grad_hist_add,
        down_weight=cfg.selector.grad_down_weight_per_level,
        seed=seed)
    s_color, s_weight = _sample_pattern(pyr0, uv, outlier_sum=osum)
    out.update(sel_uv=uv, sel_valid=valid, sel_color=s_color,
               sel_weight=s_weight)
    return out


def _pad_rows(a: np.ndarray, cap: int, fill=0.0) -> np.ndarray:
    """Pad axis 0 to ``cap`` — every device call gets ONE static shape
    (data-dependent batch sizes would recompile per size)."""
    out = np.full((cap,) + a.shape[1:], fill, a.dtype)
    out[: len(a)] = a[:cap]
    return out


# ---------------------------------------------------------------------------
# Host records
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FrameRecord:
    frame_id: int
    timestamp: float
    ref_kf: int                   # kf_id of the tracking reference
    T_from_ref: np.ndarray        # [4,4] camFromRef (SE3)
    is_kf: bool


@dataclasses.dataclass
class KeyframeRecord:
    kf_id: int
    frame_id: int
    timestamp: float
    T_cw: np.ndarray              # [4,4] worldToCam (refreshed by BA; final at marg)
    slot: int                     # window slot while active; -1 after
    in_window: bool = True
    # full Sim(3) worldToCam from the global pose graph (reference:
    # Frame::TcwOpti / setPoseOpti) — scale-aware map consumers (point
    # export, viz) compose depths through this; T_cw above is its
    # center-preserving SE3 projection used by the odometry/trajectory
    S_cw_opti: Optional[np.ndarray] = None
    # filled by the loop-closing subsystem (features, BoW vector)
    features: Optional[dict] = None


@dataclasses.dataclass
class PoseEdge:
    """Relative-pose constraint for the global Sim(3) pose graph
    (reference: Frame::poseRel, recorded at marginalization)."""

    kf_a: int
    kf_b: int
    T_ab: np.ndarray              # [4,4] SE3: a_cam ← b_cam... (T_a · T_b⁻¹)
    kind: str = "odom"            # "odom" | "loop"
    scale: float = 1.0            # Sim3 scale for loop edges


@dataclasses.dataclass
class _MapTask:
    """One tracked frame handed from the tracking front half to the
    mapping back half (reference: unmappedTrackedFrames queue entries)."""

    fid: int
    ts: float
    exposure: float
    pyr: Optional[tuple]          # device pyramid of the frame
    T_cw: np.ndarray              # [4,4] tracked worldToCam
    aff: tuple                    # (a_abs, b_abs)
    need_kf: bool
    frame_rec: "FrameRecord"
    status: dict
    traced: bool = False          # bank already traced (fused sync step)
    pyr_batch: Optional[tuple] = None   # (stacked pyr levels, index) — batch mode


# ---------------------------------------------------------------------------
# The conductor
# ---------------------------------------------------------------------------


class FullSystem:
    """End-to-end monocular direct odometry engine (loop closure is wired
    in by ldso_tpu.loop.system glue; this class is the odometry core)."""

    def __init__(self, cfg: LdsoConfig, intr, w: int, h: int,
                 async_mapping: bool = False, pipeline_depth: int = 0,
                 batch_size: int = 1):
        """``async_mapping``: run the mapping back half (trace/KF/BA) on a
        worker thread (reference: mappingLoop). ``pipeline_depth`` > 0
        additionally defers the tracking readback by that many frames so
        device dispatches pipeline ahead of host decisions — tracking
        throughput then hides the host↔device round-trip latency (only
        meaningful with async_mapping). ``batch_size`` > 1 additionally
        tracks+traces B frames per device dispatch (frame_step.fused_batch)
        — this divides the per-frame dispatch cost by B at the price of
        ≤B-1 extra frames of KF-decision latency."""
        self.cfg = cfg
        self.pipeline_depth = pipeline_depth if async_mapping else 0
        self.batch_size = batch_size if (async_mapping
                                         and pipeline_depth > 0) else 1
        self._fbuf: List[tuple] = []          # frames awaiting batch dispatch
        L = cfg.shapes.pyr_levels
        m = 1 << (L - 1)
        self.w = (w // m) * m
        self.h = (h // m) * m
        self.intr = np.asarray(intr, dtype=np.float32)
        self.intr_j = jnp.asarray(self.intr)

        self.win = win_mod.empty_window(cfg, self.h, self.w, self.intr)
        D = cfg.shapes.state_dim
        self.HM, self.bM = marginal.empty_prior(D)
        # deferred marginalization folds awaiting their f64 apply
        # (see _materialize_prior). _prior_lock guards _prior_pending,
        # HM/bM, and _slot_dirty against concurrent materialization
        # (mapping thread vs finish_mapping/save_checkpoint callers —
        # an unguarded double-apply would fold the same blocks twice).
        self._prior_pending: List[tuple] = []
        self._prior_lock = threading.Lock()
        # window slots freed by a frame marginalization whose prior fold
        # has NOT yet been applied: reusing such a slot would let a later
        # fold Schur-eliminate the NEW occupant's block — _new_kf skips
        # dirty slots until _materialize_prior clears them
        self._slot_dirty: set = set()

        self.slot_kf: List[Optional[int]] = [None] * cfg.shapes.max_frames
        self.kfs: dict[int, KeyframeRecord] = {}
        self.frames: List[FrameRecord] = []
        self.pose_edges: List[PoseEdge] = []
        # persistent global map (reference: the exposed Frame/Point layer
        # in src/Map.cc survives marginalization and its world positions
        # are refreshed after every pose-graph run). Points are archived
        # in HOST-CAMERA coordinates per kf_id at removal time; world
        # positions are derived on demand through the KF's latest
        # S_cw_opti/T_cw, so a PGO write-back corrects the whole map
        # with zero extra work. kf_id -> dict(xyz_cam [n,3], color [n]).
        self.map_points: dict[int, dict] = {}
        self.bank = bank_mod.empty_bank(cfg.shapes.max_immature)
        # bank-patch journal: the mapping thread's _commit_bank_patch
        # bumps the version and records (fn, args) so the tracking
        # thread's fused-step/batch write-back can MERGE (re-apply) any
        # patch that committed between its dispatch-time bank read and
        # its write — otherwise the KF's candidate drops + fresh seeds
        # are silently stomped by a bank derived from the pre-patch
        # snapshot (lost-update race; patch-after-trace lineage is the
        # order apply_patch's commute argument covers)
        self._bank_version = 0
        self._bank_patches: List[tuple] = []   # (version, fn, args)

        self.initializer = CoarseInitializer(cfg, self.intr)
        self.initialized = False
        self.init_failed = False
        self.is_lost = False
        self._init_frames: List[tuple] = []   # (frame_id, ts, T_first_to_cur)

        self.next_kf_id = 0
        self.frame_count = 0
        self.track_ref: Optional[tracker.TrackerRef] = None
        self.ref_kf: Optional[int] = None
        self.last_rel_ab = np.zeros(2, dtype=np.float32)
        self.T_last_cw: Optional[np.ndarray] = None
        self.T_prelast_cw: Optional[np.ndarray] = None
        self.first_coarse_rmse = -1.0
        # device-side prediction state (refToNew of the last two frames,
        # relative to the CURRENT tracking ref) — lets track_step compute
        # the constant-velocity seed in-program, no readback needed
        eye = jnp.eye(4, dtype=jnp.float32)
        self._T_last_rel = eye
        self._T_prelast_rel = eye
        self._ab_rel_dev = jnp.zeros(2, jnp.float32)   # batch-mode carry
        self._T_ref_cw_dev = eye
        self._T_ref_cw_np = np.eye(4)
        self._ref_version = 0            # bumped at every tracker-ref swap
        self._dispatch_ref_version = 0
        self._dispatch_T_ref_np = np.eye(4)
        self._dispatch_T_ref_dev = eye
        self._async_copy_ok = True       # device→host async copy support
        self._n_active_cache = 0         # active-point count (updated per KF)
        self.kf_ms: List[float] = []     # wall ms per keyframe build
        self.kf_stage_ms: List[dict] = []  # per-KF stage breakdown
        # end-to-end frame→pose latency (submit at add_frame → pose
        # available in _process_tracked; pipelined/batched modes defer
        # the readback, so this is the honest "realtime" latency number)
        self.frame_latency_ms: List[float] = []
        self._t_submit: dict = {}
        # KF decisions suppressed because one KF was already in flight
        # (work-shedding; reference: needNewKFAfter keeps ONE pending KF)
        self.kf_suppressed = 0
        self.kf_shed_events = 0
        # (fid, delta) of the frame that last TRIGGERED a keyframe —
        # lets lagging stale-ref votes be re-evaluated as
        # delta − trigger_delta (see _process_tracked)
        self._kf_trigger_fid = -1
        self._kf_trigger_delta = 0.0
        self._pending: collections.deque = collections.deque()
        # adaptive activation spacing (reference: currentMinActDist)
        self._min_act_dist = cfg.selector.min_act_dist
        self._last_act_stats: dict = {}
        self.metrics: List[dict] = []
        self.last_idepth_hessian: Optional[np.ndarray] = None  # [P] post-BA
        # hooks the loop-closing subsystem assigns
        self.on_keyframe = None
        self.loop_closing = None

        # guards host registries shared with async loop-closure/PGO
        # workers (kfs dict mutation, pose_edges append, pose write-back)
        self.state_lock = threading.Lock()

        # track ∥ map pipeline (reference: FullSystem::deliverTrackedFrame +
        # mappingLoop — queue depth ≤3, non-KF frames dropped under backlog,
        # KFs never dropped)
        self._async = async_mapping
        self._map_queue: collections.deque = collections.deque()
        self._map_cv = threading.Condition()
        self._map_busy = False
        self._map_exc: Optional[BaseException] = None
        self._kf_inflight = 0         # KFs queued/being built by mapping
        self._kf_want_streak = 0      # consecutive suppressed KF wants
        # deferred KF bookkeeping, FIFO (see _finish_kf): up to
        # max_frames - max_kf keyframes may have their finish (the BA
        # readback + marginalization bookkeeping) in flight at once —
        # the build path NEVER waits on a device readback
        self._kf_finish_q: collections.deque = collections.deque()
        self._map_running = True
        self._map_thread: Optional[threading.Thread] = None
        if async_mapping:
            self._map_thread = threading.Thread(
                target=self._mapping_loop, name="ldso-mapping", daemon=True)
            self._map_thread.start()

    # ------------------------------------------------------------------
    # Public API (reference: addActiveFrame / printResult)
    # ------------------------------------------------------------------

    @property
    def immatures(self) -> HostBank:
        """Host snapshot of the device-resident immature bank."""
        return bank_mod.to_host(self.bank)

    def add_frame(self, img, timestamp: Optional[float] = None,
                  exposure: float = 1.0) -> dict:
        import time as _time

        fid = self.frame_count
        self.frame_count += 1
        self._t_submit[fid] = _time.perf_counter()
        ts = float(timestamp) if timestamp is not None else float(fid)
        # keep uint8 frames uint8: the device programs widen on the
        # device, and the h2d transfer is 4x smaller
        img = np.asarray(img)[: self.h, : self.w]
        if img.dtype != np.uint8:
            img = img.astype(np.float32, copy=False)

        if self.initialized and not self.is_lost:
            return self._track_and_map(fid, ts, exposure, img)

        pyr, _ = build_pyramid(jnp.asarray(img), self.cfg.shapes.pyr_levels)
        if self.is_lost:
            # relocalization by BoW + PnP re-anchor (new capability — the
            # reference has the database but never recovers, SURVEY §5.3)
            if self.loop_closing is not None:
                rel = self.loop_closing.relocalize(self, pyr)
                if rel is not None:
                    self.is_lost = False
                    self.T_last_cw = rel["T_cw"]
                    self.T_prelast_cw = rel["T_cw"].copy()
                    self.first_coarse_rmse = -1.0
                    self._resync_prediction(self._T_ref_cw_np)
                    return dict(status="relocalized", frame_id=fid,
                                anchor_kf=rel["kf_id"],
                                n_inliers=rel["n_inliers"])
            return dict(status="lost", frame_id=fid)
        return self._initializer_step(fid, ts, exposure, pyr)

    def export_trajectory(self):
        """(timestamps [N], T_cw [N,4,4]) for every tracked frame — frame
        poses composed onto their reference KF's FINAL pose (reference:
        FullSystem::printResult composes shells onto optimized KFs)."""
        ts_out, poses = [], []
        for fr in self.frames:
            kf = self.kfs.get(fr.ref_kf)
            if kf is None:
                continue
            ts_out.append(fr.timestamp)
            poses.append(fr.T_from_ref @ kf.T_cw)
        return np.asarray(ts_out), np.asarray(poses)

    def write_metrics(self, path: str):
        with open(path, "w") as f:
            for m in self.metrics:
                f.write(json.dumps(m) + "\n")

    # ------------------------------------------------------------------
    # Initialization path (reference: FullSystem init branch +
    # initializeFromInitializer)
    # ------------------------------------------------------------------

    def _initializer_step(self, fid, ts, exposure, pyr) -> dict:
        init = self.initializer
        if init.frame_id_first is None:
            gsq = [jnp.sum(p[..., 1:3] ** 2, axis=-1) for p in pyr]
            init.set_first(pyr, gsq)
            init.frame_id_first = fid
            self._init_frames = [(fid, ts, np.eye(4))]
            self._first_pyr = pyr
            self._first_exposure = exposure
            self._first_ts = ts
            return dict(status="init_first", frame_id=fid)

        st = init.track(pyr)
        self._init_frames.append((fid, ts, np.asarray(init.T, dtype=np.float64)))
        if st["done"]:
            self._init_from_initializer(fid, ts, exposure, pyr)
            return dict(status="initialized", frame_id=fid, **st)
        # bootstrap divergence → restart from scratch on this frame
        # (reference: initFailed → the runner rebuilds the system)
        if init.frames_tracked > 30 and not init.snapped:
            self.init_failed = True
            init.frame_id_first = None
            init.frames_tracked = 0
            return dict(status="init_reset", frame_id=fid)
        return dict(status="initializing", frame_id=fid, **st)

    def _init_from_initializer(self, fid, ts, exposure, pyr):
        cfg = self.cfg
        res = self.initializer.results()
        rescale = res.get("rescale", 1.0)

        # first KF at world origin, second at the bootstrap pose
        kf0 = self._new_kf(self._init_frames[0][0], self._first_ts, np.eye(4),
                           self._first_pyr[0], self._first_exposure,
                           aff_ab=(0.0, 0.0))
        T1 = np.asarray(res["T_first_to_new"], dtype=np.float64)
        ab1 = res["ab"]
        kf1 = self._new_kf(fid, ts, T1, pyr[0], exposure,
                           aff_ab=(float(ab1[0]), float(ab1[1])))

        # points hosted by KF0 (padded to capacity: single static shape)
        good = np.asarray(res["good"])
        order = np.flatnonzero(good)
        P = cfg.shapes.max_points
        k = min(len(order), P)
        order = order[:k]
        uv = _pad_rows(np.asarray(res["uv"], np.float32)[order], P)
        idepth = _pad_rows(np.asarray(res["idepth"], np.float32)[order], P, 1.0)
        slots = np.full(P, P, np.int32)
        slots[:k] = np.arange(k)
        color, weight = _sample_pattern(
            self.win.images[kf0.slot], jnp.asarray(uv),
            outlier_sum=float(cfg.ba.outlier_th_sum_component))
        self.win = win_mod.add_points(
            self.win, slots, kf0.slot, uv,
            np.asarray(color), np.asarray(weight), idepth)

        # polish with one BA round
        self._run_ba()
        self._refresh_kf_poses()

        # record the in-between bootstrap frames (translations rescaled)
        for i, (f_id, f_ts, T) in enumerate(self._init_frames):
            T = T.copy()
            T[:3, 3] /= rescale
            self.frames.append(FrameRecord(f_id, f_ts, kf0.kf_id, T,
                                           is_kf=(i == 0)))
        self.frames[-1] = FrameRecord(fid, ts, kf1.kf_id, np.eye(4), True)

        self._seed_new_kf(kf1.slot, self._dispatch_seed(pyr, fid))
        self._update_tracker_ref(kf1)
        self.T_last_cw = np.asarray(self.kfs[kf1.kf_id].T_cw)
        self.T_prelast_cw = np.eye(4)
        self._resync_prediction(self._T_ref_cw_np)
        self.initialized = True
        if self.on_keyframe is not None:
            self.on_keyframe(self, kf0, self._first_pyr)
            self.on_keyframe(self, kf1, pyr)

    # ------------------------------------------------------------------
    # Steady-state tracking (reference: trackNewCoarse + deliverTrackedFrame)
    # ------------------------------------------------------------------

    def _track_and_map(self, fid, ts, exposure, img) -> dict:
        if self.batch_size > 1:
            self._fbuf.append((fid, ts, float(exposure), img))
            if len(self._fbuf) >= self.batch_size:
                return self._flush_batch()
            return dict(status="pending", frame_id=fid)
        return self._track_single(fid, ts, exposure, img)

    def _reexpress_carries(self, T_ref_np, ref_version, T_ref_dev):
        """Ref swapped since the last dispatch → re-express the device
        prediction pair relative to the new ref WITHOUT draining the
        pipeline: T_rel_new = T_rel_old · T_oldref_cw · T_newref_cw⁻¹
        is a pure device-side right-multiply against the EXACT device
        ref poses (the host copies may still be tracked estimates while
        a KF finish is pending). The relative-affine carry resets to
        zero exactly like the per-frame path's last_rel_ab."""
        if self._dispatch_ref_version == ref_version:
            return
        self._T_last_rel, self._T_prelast_rel = _reexpress_jit(
            self._T_last_rel, self._T_prelast_rel,
            self._dispatch_T_ref_dev, T_ref_dev)
        self._ab_rel_dev = jnp.zeros(2, jnp.float32)
        self._dispatch_ref_version = ref_version
        self._dispatch_T_ref_np = T_ref_np
        self._dispatch_T_ref_dev = T_ref_dev

    def _flush_batch(self) -> dict:
        """Dispatch the buffered frames as ONE fused track+trace program
        (frame_step.fused_batch): one h2d (stacked uint8 frames), one
        dispatch, and later one d2h (stacked diags) per B frames."""
        meta, self._fbuf = self._fbuf, []
        if not meta:
            return dict(status="pending")
        if len(meta) < self.batch_size:
            # tail flush (sequence end): per-frame path for the leftovers
            st: dict = dict(status="pending")
            for fid, ts, expo, img in meta:
                st = self._track_single(fid, ts, expo, img)
                if st.get("status") == "lost":
                    break
            return st
        cfg = self.cfg
        with self.state_lock:
            ref = self.track_ref
            ref_kf_id = self.ref_kf
            T_ref_np = self._T_ref_cw_np
            T_ref_dev = self._T_ref_cw_dev
            ref_version = self._ref_version
            bank = self.bank
            bank_version = self._bank_version
            T_eval, x_win, expo_win = (self.win.T_eval, self.win.x,
                                       self.win.exposure)
        self._reexpress_carries(T_ref_np, ref_version, T_ref_dev)

        imgs = np.stack([m[3] for m in meta])
        expos = np.asarray([m[2] for m in meta], np.float32)
        out = frame_step.fused_batch(
            jnp.asarray(imgs), jnp.asarray(expos), ref, self._T_last_rel,
            self._T_prelast_rel, self._ab_rel_dev, bank, T_eval, x_win,
            expo_win, T_ref_dev, self.intr_j, cfg)
        self._commit_traced_bank(out.bank, bank_version)
        self._T_last_rel = out.T_last
        self._T_prelast_rel = out.T_prelast
        self._ab_rel_dev = out.ab_rel

        # start the stacked-diag d2h NOW: by the time this batch ages out
        # of the pipeline the values are host-side and the read is free
        # (a blocking per-batch read waits on the device instead)
        if self._async_copy_ok:
            try:
                out.diags.copy_to_host_async()
            except (AttributeError, NotImplementedError):
                self._async_copy_ok = False
        import time as _time

        self._pending.append(("batch", meta, out, ref_kf_id, T_ref_np,
                              ref_version, _time.perf_counter()))
        max_batches = max(1, self.pipeline_depth // self.batch_size)
        st = None
        while self._pending and self._entry_due(self._pending[0],
                                                cap=max_batches):
            if not self._entry_ready(self._pending[0]):
                st = self._drain_stacked()     # one pull, whole backlog
            else:
                st = self._process_entry(self._pending.popleft())
            if st and st.get("status") == "lost":
                return st
        return st or dict(status="pending", frame_id=meta[-1][0])

    def _drain_stacked(self) -> dict:
        """Read EVERY pending tracking result with ONE device_get (their
        device→host copies are already in flight, so it waits once, for
        the newest). Taken when the oldest entry ages past MAX_DEFER_S
        with its async copies still in flight: pulling entries one
        blocking read at a time would put one device wait PER FRAME on
        the tracking path. The rows are stacked on the host: a device
        concatenate would compile once per backlog length, and the
        backlog's length depends on timing."""
        entries = list(self._pending)
        self._pending.clear()
        parts = [(e[1][3].diag if e[0] == "single" else e[2].diags)
                 for e in entries]
        diags = np.concatenate([np.atleast_2d(p)
                                for p in jax.device_get(parts)], axis=0)
        st, row = None, 0
        for e in entries:
            if e[0] == "single":
                fid, ts, expo, out, ref_kf_id, T_ref_np, ref_ver = e[1]
                st = self._process_tracked(fid, ts, expo, out, ref_kf_id,
                                           T_ref_np, diag=diags[row],
                                           ref_version=ref_ver)
                row += 1
            else:
                _, meta, out, ref_kf_id, T_ref_np, ref_ver = e[:6]
                for i, (fid, ts, expo, _img) in enumerate(meta):
                    st = self._process_tracked(fid, ts, expo, out,
                                               ref_kf_id, T_ref_np,
                                               diag=diags[row + i],
                                               batch_idx=i,
                                               ref_version=ref_ver)
                    if st.get("status") == "lost":
                        return st
                row += len(meta)
            if st and st.get("status") == "lost":
                return st
        return st

    def _process_entry(self, entry) -> dict:
        if entry[0] == "single":
            fid, ts, expo, out, ref_kf_id, T_ref_np, ref_ver = entry[1]
            return self._process_tracked(fid, ts, expo, out, ref_kf_id,
                                         T_ref_np, ref_version=ref_ver)
        _, meta, out, ref_kf_id, T_ref_np, ref_ver = entry[:6]
        diags = np.asarray(out.diags)      # the per-batch readback
        st: dict = dict(status="pending")
        for i, (fid, ts, expo, _img) in enumerate(meta):
            st = self._process_tracked(fid, ts, expo, out, ref_kf_id,
                                       T_ref_np, diag=diags[i], batch_idx=i,
                                       ref_version=ref_ver)
            if st.get("status") == "lost":
                break
        return st

    def _track_single(self, fid, ts, exposure, img) -> dict:
        cfg = self.cfg
        with self.state_lock:     # consistent ref bundle (async: mapping swaps)
            ref = self.track_ref
            ref_kf_id = self.ref_kf
            T_ref_np = self._T_ref_cw_np
            T_ref_dev = self._T_ref_cw_dev
            ref_version = self._ref_version
            bank = self.bank
            bank_version = self._bank_version
            # window fields for the fused trace (async: the mapping
            # thread swaps self.win — capture a consistent pytree)
            win_snap = self.win

        # re-express in-flight prediction carries on a ref swap (the old
        # per-KF _drain_pending() flushed the whole pipeline at every
        # keyframe). _dispatch_T_ref_* is tracking-thread-local: the ref
        # pose the in-flight dispatches were actually expressed against.
        self._reexpress_carries(T_ref_np, ref_version, T_ref_dev)

        ab0 = jnp.asarray(self.last_rel_ab, jnp.float32)
        # BOTH paths use the fused track+trace program: the pipelined
        # mode used to dispatch track_step here and a separate trace_step
        # per non-KF frame on the mapping thread — one extra device
        # dispatch per frame. Fusing also traces EVERY frame (the mapping
        # thread used to shed trace tasks under backlog).
        out = frame_step.fused_step(
            jnp.asarray(img), ref, self._T_last_rel,
            self._T_prelast_rel, ab0, bank, win_snap.T_eval,
            win_snap.x, win_snap.exposure, T_ref_dev,
            self.intr_j, jnp.float32(exposure), cfg)
        self._commit_traced_bank(out.bank, bank_version)
        self._T_prelast_rel = self._T_last_rel
        self._T_last_rel = out.T

        import time as _time

        rec = (fid, ts, exposure, out, ref_kf_id, T_ref_np, ref_version)
        if self.pipeline_depth > 0:
            # deferred decision: dispatch ahead, read results late. The
            # diag's device→host copy is STARTED at dispatch
            # (copy_to_host_async); entries are drained as soon as their
            # value is device-ready, with pipeline_depth as the upper
            # bound — so the KF decision lags by the device's latency,
            # not by a fixed depth (decision
            # staleness directly costs trajectory accuracy in async
            # mode: the new ref is built from the flagged frame).
            if self._async_copy_ok:
                try:
                    out.diag.copy_to_host_async()
                except (AttributeError, NotImplementedError):
                    self._async_copy_ok = False
            self._pending.append(("single", rec, _time.perf_counter()))
            if self._async_copy_ok:
                st = None
                while self._pending and self._entry_due(self._pending[0]):
                    if not self._entry_ready(self._pending[0]):
                        # due by AGE, copies not landed: ONE stacked
                        # pull for the whole backlog instead of one
                        # blocking read per entry
                        st = self._drain_stacked()
                    else:
                        st = self._process_entry(self._pending.popleft())
                    if st and st.get("status") == "lost":
                        return st
                return st or dict(status="pending", frame_id=fid)
            if len(self._pending) > self.pipeline_depth:
                # fallback (no async copies): batch one stacked d2h
                # transfer to amortize the wait over depth/2 frames
                k = max(1, self.pipeline_depth // 2)
                batch = [self._pending.popleft()[1] for _ in range(k)]
                diags = np.asarray(jnp.stack([b[3].diag for b in batch]))
                st = None
                for b, diag in zip(batch, diags):
                    st = self._process_tracked(*b[:6], diag=diag,
                                               ref_version=b[6])
                    if st.get("status") == "lost":
                        break
                return st
            return dict(status="pending", frame_id=fid)
        return self._process_entry(("single", rec))

    @staticmethod
    def _entry_ready(entry) -> bool:
        try:
            if entry[0] == "single":
                return entry[1][3].diag.is_ready()
            return entry[2].diags.is_ready()
        except AttributeError:
            return True

    # oldest a deferred tracking result may get before it is read with a
    # BLOCKING pull: under continuous dispatch load results can stay
    # unready far past their compute time, and an unbounded
    # defer turns directly into KF-decision staleness (= accuracy)
    MAX_DEFER_S = 0.1

    def _entry_due(self, entry, cap: int = None) -> bool:
        if len(self._pending) > (cap or self.pipeline_depth):
            return True
        if self._async_copy_ok and self._entry_ready(entry):
            return True
        import time as _time

        return _time.perf_counter() - entry[-1] > self.MAX_DEFER_S

    def _commit_traced_bank(self, traced_bank, bank_version: int):
        """Write a traced bank back to self.bank, re-applying any bank
        patch the mapping thread committed since ``bank_version`` was
        captured at dispatch (lost-update fix: the KF's drops + seeds
        must survive a concurrent fused-step/batch write-back)."""
        with self.state_lock:
            if self._bank_version != bank_version:
                if self._bank_patches \
                        and bank_version < self._bank_patches[0][0] - 1:
                    # journal underrun: patches between this dispatch's
                    # read and now were already trimmed — the write-back
                    # would silently stomp them (advisor r4). 24 retained
                    # entries make this unreachable at ≤3 KFs in flight.
                    raise RuntimeError(
                        f"bank-patch journal underrun: dispatch read "
                        f"v{bank_version}, oldest retained "
                        f"v{self._bank_patches[0][0]}")
                for ver, fn, args in self._bank_patches:
                    if ver > bank_version:
                        traced_bank = fn(traced_bank, *args)
            self.bank = traced_bank

    def _commit_bank_patch(self, fn, *args):
        """Apply a bank-surgery op to the LIVE device bank under lock
        and journal it for merge-aware tracking write-backs."""
        with self.state_lock:
            self.bank = fn(self.bank, *args)
            self._bank_version += 1
            self._bank_patches.append((self._bank_version, fn, args))
            # journal tail: up to max_frames−max_kf keyframes may have
            # patches in flight (build seed + activation drop + finish
            # cull each), so retain generously; _commit_traced_bank
            # asserts the window was deep enough (advisor r4, low)
            del self._bank_patches[:-24]

    def _resync_prediction(self, T_ref_cw: np.ndarray):
        """Re-express the device-side (T_last, T_prelast) prediction pair
        relative to ``T_ref_cw`` from the host trajectory state (hard
        sync points only: initialization, relocalization)."""
        inv_ref = np.linalg.inv(T_ref_cw)
        T_l = (self.T_last_cw @ inv_ref if self.T_last_cw is not None
               else np.eye(4))
        T_p = (self.T_prelast_cw @ inv_ref
               if self.T_prelast_cw is not None else T_l)
        self._T_last_rel = jnp.asarray(T_l, jnp.float32)
        self._T_prelast_rel = jnp.asarray(T_p, jnp.float32)
        self._ab_rel_dev = jnp.zeros(2, jnp.float32)
        self._dispatch_T_ref_np = np.asarray(T_ref_cw, np.float64).copy()
        self._dispatch_T_ref_dev = jnp.asarray(self._dispatch_T_ref_np,
                                               jnp.float32)
        self._dispatch_ref_version = self._ref_version

    def _drain_pending(self):
        if self.batch_size > 1 and self._fbuf:
            self._flush_batch()        # tail frames (per-frame path)
        while self._pending:
            self._process_entry(self._pending.popleft())

    def _process_tracked(self, fid, ts, exposure, out, ref_kf_id,
                         T_ref_cw, diag=None, batch_idx=None,
                         ref_version=None) -> dict:
        """Consume one tracking result: lost check, trajectory record,
        KF decision, hand-off to the mapping back half."""
        import time as _time

        cfg = self.cfg
        if diag is None:
            diag = np.asarray(out.diag)           # the per-frame readback
        t_sub = self._t_submit.pop(fid, None)
        if t_sub is not None:
            self.frame_latency_ms.append(1e3 * (_time.perf_counter() - t_sub))
        rmse0 = float(diag[frame_step.DIAG_RMSE0])
        if self.first_coarse_rmse < 0:
            self.first_coarse_rmse = rmse0
        if not np.isfinite(rmse0) or rmse0 > 4.0 * max(self.first_coarse_rmse, 1e-3):
            self.is_lost = True
            self._pending.clear()     # later frames tracked a lost state
            self._fbuf.clear()
            return dict(status="lost", frame_id=fid, rmse=rmse0)

        T_rel = diag[frame_step.DIAG_T:].reshape(4, 4).astype(np.float64)
        T_cw = T_rel @ T_ref_cw
        ab_rel = diag[frame_step.DIAG_A_REL:frame_step.DIAG_B_REL + 1]
        self.last_rel_ab = ab_rel.astype(np.float32)
        self.frames.append(FrameRecord(fid, ts, ref_kf_id, T_rel, False))

        flow = diag[frame_step.DIAG_FLOW_T:frame_step.DIAG_FLOW_R + 1]
        delta = float(diag[frame_step.DIAG_KF_DELTA])
        need_kf = delta > 1.0 or 2.0 * self.first_coarse_rmse < rmse0
        # stale-decision handling: this frame's flow/delta was measured
        # against a ref that has since been REPLACED — taken at face
        # value its KF vote would re-trigger a KF right after every swap
        # (measured: 52 vs 12 KFs over 100 frames). Round 4 DISCARDED
        # such votes outright, but when the readback lag spans several
        # frames every vote in that window dies, KF cadence collapses,
        # and ref staleness (= accuracy) grows with it. Instead,
        # RE-EVALUATE the vote relative
        # to the frame that triggered the last KF: both deltas were
        # measured against the SAME old ref, so their difference
        # approximates the motion accumulated since the new keyframe
        # (reference analog: after makeKeyFrame the tracker decides on
        # new-ref frames — this reconstructs that decision through lag).
        eff_delta = delta
        if ref_version is not None and ref_version != self._ref_version:
            # staleness RELATIVE to the newest keyframe, reconstructed
            # through the lag (see comment above) — used both for the
            # re-evaluated vote and for the shedding gate below (raw
            # delta keeps growing against the dead ref and would trip
            # the too_stale wait on every frame of a lag window)
            eff_delta = (delta - self._kf_trigger_delta
                         if fid > self._kf_trigger_fid else 0.0)
            if need_kf:
                need_kf = eff_delta > 1.0
        # bounded keyframes in flight (reference: needNewKFAfter keeps
        # ONE pending KF; round 5 allows cfg.tracker.max_kf_inflight —
        # the deferred-finish builds tolerate it and a second in-flight
        # KF beats shedding when one build spans many frames)
        max_inflight = max(int(cfg.tracker.max_kf_inflight), 1)
        if need_kf and self._async and self._kf_inflight >= max_inflight:
            self._kf_want_streak += 1
            max_sup = cfg.tracker.max_kf_suppress
            # staleness bound: delta IS the integrated
            # flow/affine change against the current (stale) ref — gate
            # shedding on it directly, so ref staleness is bounded in
            # SCENE units, not frame counts (a frame-count cap sheds
            # unboundedly more motion the faster the input runs)
            too_stale = eff_delta > cfg.tracker.max_stale_delta \
                or (max_sup > 0 and self._kf_want_streak >= max_sup)
            if too_stale:
                # quality floor: wait for the in-flight KF instead of
                # shedding yet another wanted one (reference: non-
                # realtime mode blocks on every KF build; this is the
                # dial between that and free shedding). The wait has no
                # time bound: a build stalled for seconds (a first-call
                # compile, a slow card) would otherwise let tracking run
                # on past the staleness bound. A failed mapping thread
                # ends it; the failure is raised at the next delivery.
                with self._map_cv:
                    self._map_cv.wait_for(
                        lambda: (self._kf_inflight < max_inflight
                                 or self._map_exc is not None))
            if self._kf_inflight >= max_inflight:
                need_kf = False
                self.kf_suppressed += 1
                # distinct shed EVENTS (want-windows), not want-frames:
                # re-evaluated votes re-fire every frame of a readback
                # lag window, so the raw count inflates with readback
                # latency; one window ~ one wanted-but-deferred keyframe
                if self._kf_want_streak == 1:
                    self.kf_shed_events += 1
        if need_kf:
            self._kf_trigger_fid = fid
            self._kf_trigger_delta = delta
        if need_kf and self._async:
            # increment under _map_cv: the mapping thread's decrement is
            # lock-protected, and a lost update here would leave
            # _kf_inflight stuck > 0 — every later wanted KF would then
            # block on the 10 s wait_for timeout (advisor r4, medium)
            with self._map_cv:
                self._kf_inflight += 1
            self._kf_want_streak = 0

        status = dict(status="tracked", frame_id=fid, rmse=rmse0,
                      flow=flow.tolist(), need_kf=bool(need_kf),
                      # host-cached count (reading win.p_valid here would
                      # wait on the device on EVERY tracked frame)
                      n_active=self._n_active_cache)
        a_abs = float(diag[frame_step.DIAG_A_ABS])
        b_abs = float(diag[frame_step.DIAG_B_ABS])

        if batch_idx is not None:
            # batch mode: tracing already ran in the fused program; only
            # keyframes have mapping work left (the pyramid rides as a
            # lazy (stacked levels, index) pair, materialized by ONE
            # slice dispatch in the mapping thread)
            if need_kf:
                task = _MapTask(fid, ts, exposure, None, T_cw,
                                (a_abs, b_abs), True, self.frames[-1],
                                status, traced=True,
                                pyr_batch=(out.pyr, batch_idx))
                if self._async:
                    self._deliver_tracked_frame(task)
                else:
                    self._map_frame(task)
        elif need_kf:
            # fused_step traced this frame in-dispatch; non-KF frames
            # have no mapping work left — only keyframes are delivered
            task = _MapTask(fid, ts, exposure, out.pyr, T_cw, (a_abs, b_abs),
                            True, self.frames[-1], status, traced=True)
            if self._async:
                self._deliver_tracked_frame(task)
            else:
                self._map_frame(task)

        self.T_prelast_cw = self.T_last_cw
        self.T_last_cw = T_cw
        self.metrics.append(dict(frame=fid, **{k: v for k, v in status.items()
                                               if k != "status"}))
        return status

    # ------------------------------------------------------------------
    # Track ∥ map pipeline (reference: deliverTrackedFrame + mappingLoop)
    # ------------------------------------------------------------------

    def _deliver_tracked_frame(self, task: _MapTask):
        if self._map_exc is not None:
            exc, self._map_exc = self._map_exc, None
            raise exc
        with self._map_cv:
            if task.need_kf:
                # a keyframe supersedes queued non-KF trace work: drop it
                # so the build starts immediately (reference: mappingLoop
                # skips intermediate frames to reach the needed KF —
                # ref staleness costs accuracy, stale traces do not)
                for i in range(len(self._map_queue) - 1, -1, -1):
                    if not self._map_queue[i].need_kf:
                        del self._map_queue[i]
            self._map_queue.append(task)
            # backlog control: mapping may lag ≤3 frames; drop the oldest
            # non-KF frames first (reference: mappingLoop skip-logic), KFs
            # always survive and effectively jump the queue
            while len(self._map_queue) > 3:
                for i, t in enumerate(self._map_queue):
                    if not t.need_kf:
                        del self._map_queue[i]
                        break
                else:
                    break
            self._map_cv.notify_all()

    def _mapping_loop(self):
        while True:
            with self._map_cv:
                while not self._map_queue and self._map_running:
                    if self._kf_finish_q:
                        # idle with deferred KF finishes: poll their copies
                        self._map_cv.wait(0.003)
                        break
                    self._map_cv.wait()
                if not self._map_queue and not self._map_running \
                        and not self._kf_finish_q:
                    return
                task = (self._map_queue.popleft() if self._map_queue
                        else None)
                self._map_busy = True
            try:
                if task is not None:
                    self._map_frame(task)
                # deferred KF bookkeeping: entries run when their copies
                # landed; forced only on shutdown (never mid-run — the
                # age bound inside _finish_kf handles stragglers)
                self._finish_kf(wait=(task is None
                                      and not self._map_running))
                self._materialize_prior(wait=False)
            except BaseException as e:    # surfaced on next deliver/finish
                self._map_exc = e
            finally:
                with self._map_cv:
                    self._map_busy = False
                    self._map_cv.notify_all()

    def finish_mapping(self):
        """Block until the mapping backlog drains (reference:
        FullSystem::blockUntilMappingIsFinished). Also flushes the
        pipelined tracking results still awaiting their readback."""
        self._drain_pending()
        if not self._async:
            self._finish_kf(wait=True)
            self._materialize_prior(wait=True)
            return
        with self._map_cv:
            while self._map_queue or self._map_busy or self._kf_finish_q:
                self._map_cv.wait(0.05)
        if self._map_exc is not None:
            exc, self._map_exc = self._map_exc, None
            raise exc
        self._materialize_prior(wait=True)

    def shutdown(self):
        """Stop the mapping thread (after finish_mapping)."""
        if self._map_thread is None:
            return
        self.finish_mapping()
        with self._map_cv:
            self._map_running = False
            self._map_cv.notify_all()
        self._map_thread.join(timeout=30.0)
        self._map_thread = None

    def _map_frame(self, task: _MapTask):
        pyr = task.pyr
        if pyr is None and task.pyr_batch is not None:
            pyr = frame_step.slice_pyr(task.pyr_batch[0],
                                       jnp.int32(task.pyr_batch[1]))
        if task.need_kf:
            self._make_keyframe(task.fid, task.ts, task.exposure, pyr,
                                task.T_cw, task.aff, task.status,
                                task.frame_rec, traced=task.traced)
        elif not task.traced:
            self._trace_immatures(pyr[0], task.T_cw, task.exposure,
                                  task.aff)

    # ------------------------------------------------------------------
    # Keyframe path (reference: makeKeyFrame)
    # ------------------------------------------------------------------

    def _make_keyframe(self, fid, ts, exposure, pyr, T_cw, aff_ab, status,
                       frame_rec: Optional[FrameRecord] = None,
                       traced: bool = False):
        """ZERO blocking device round trips in the build: every stage —
        trace, window insert, device-side activation (ldso_tpu.lifecycle),
        the fused BA loop, the candidate-seed program, and the tracker-ref
        swap — is a fire-and-forget dispatch; the ref swap hands the
        tracking thread DEVICE futures of the post-BA reference, so
        frames dispatched right after the swap already track against the
        new keyframe (ZERO ref staleness — better than the reference,
        whose mapping thread swaps only after the full build,
        CoarseTracker::setCoarseTrackingRef). The host bookkeeping that
        needs the BA values (marginalization flags, pose records,
        reseeding, loop-closure handoff) is DEFERRED to _finish_kf.

        Finishes are a FIFO queue, and a build does not wait for the previous
        keyframe's finish: the previous BA readback may still be in flight when
        the next KF is wanted, and waiting here would serialize every KF on its
        readback. Spare window slots (shapes.max_frames − window.max_kf = 3)
        absorb the deferred marginalizations; the build blocks only in the rare
        case that every spare is exhausted AND no clean freed slot exists.
        Reference: makeKeyFrame is pure local compute (FullSystem.cc:~L700); the
        build/finish split keeps KF cadence independent of readback latency."""
        import time as _time

        t_kf0 = _time.perf_counter()
        stage = {}
        self._finish_kf(wait=False)      # opportunistic: landed finishes
        self._materialize_prior(wait=False)
        # slot guarantee: wait (rare) only when no clean free slot exists
        while self._free_slot() is None:
            if self._kf_finish_q:
                self._finish_kf(wait=True, max_entries=1)
                self._materialize_prior(wait=False)
            elif self._prior_pending:
                self._materialize_prior(wait=True)
            else:       # unreachable: occupancy ≤ max_kf once drained
                raise RuntimeError("window full with no finish pending")
        stage["slot_wait"] = 1e3 * (_time.perf_counter() - t_kf0)
        t_kf0 = _time.perf_counter()

        def _mark(name, _t=[t_kf0]):
            now = _time.perf_counter()
            stage[name] = 1e3 * (now - _t[0])
            _t[0] = now

        cfg = self.cfg
        if not traced:
            self._trace_immatures(pyr[0], T_cw, exposure, aff_ab)

        kf = self._new_kf(fid, ts, T_cw, pyr[0], exposure, aff_ab)
        rec = frame_rec if frame_rec is not None else self.frames[-1]
        rec.ref_kf = kf.kf_id
        rec.T_from_ref = np.eye(4)
        rec.is_kf = True
        self.win = win_mod.connect_new_frame(self.win, kf.slot)

        # device-side activation: GN + gates + spacing + window scatter
        # in one dispatch; only the adaptive-spacing ladder (sequential
        # scalar state) stays on the host
        mad_px = self._update_min_act_dist()
        with self.state_lock:
            bank_dev = self.bank
        self.win, act_drop, act_stats = lifecycle.kf_activate(
            self.win, bank_dev, self.intr_j, jnp.int32(kf.slot),
            jnp.float32(mad_px), cfg)
        self._commit_bank_patch(bank_mod.drop_rows, act_drop)
        seed_fut = self._dispatch_seed(pyr, fid)
        _mark("insert")

        # fused BA loop: dispatch + async diag copies, NO readback here.
        # The prior may still have unlanded folds pending — BA runs with
        # whatever is materialized (a fold lags at most ~1 readback;
        # its points are already out of the window either way)
        with self._prior_lock:
            HM, bM = self.HM, self.bM
        active_rec = [(kid, s) for s, kid in enumerate(self.slot_kf)
                      if kid is not None]
        self.win, ba_diag = solve.run_ba_dispatch(
            self.win, HM, bM, cfg, anchor_slot=self._oldest_slot())
        _mark("ba_dispatch")

        # swap the tracker ref to the post-BA device state NOW
        self._swap_tracker_ref_device(kf)
        _mark("ref_swap")

        # fresh candidates enter the bank NOW (tracing starts with the
        # very next frame) — the old finish-time seeding lagged by one
        # BA readback, starving the bank for one readback per KF. The
        # marginalization cull (which DOES need the readback) lands as
        # its own patch in _finish_one.
        self._seed_new_kf(kf.slot, seed_fut)
        _mark("seed")

        # the KF no longer blocks decisions: cadence is sync-like
        if self._async and self._kf_inflight > 0:
            with self._map_cv:
                self._kf_inflight -= 1
                self._map_cv.notify_all()    # wakes backpressured tracking

        self._kf_finish_q.append(dict(
            kf=kf, ba_diag=ba_diag, act_stats=act_stats, seed_fut=seed_fut,
            pyr=pyr, status=status, stage=stage, t_build0=t_kf0,
            active_rec=active_rec,
            t_build_ms=1e3 * (_time.perf_counter() - t_kf0)))
        if not self._async:
            self._finish_kf(wait=True)

    # a deferred finish older than this is fetched BLOCKING even if its
    # copies have not signalled ready — bounds the informational lag of
    # pose records / loop-closure handoff (and guarantees liveness when
    # async-copy readiness never flips on some backends)
    FORCE_FINISH_S = 1.0

    def _finish_kf(self, wait: bool, max_entries: int = None):
        """Deferred half of keyframe builds, FIFO: each entry runs once
        its BA diag's async copies have landed (or immediately with
        wait=True; or when older than FORCE_FINISH_S). Host bookkeeping
        only — marginalization decisions, prior folds (themselves
        deferred again), pose records, candidate reseed, loop-closure
        handoff. Nothing the NEXT build needs synchronously lives here:
        it consumes spare window slots instead."""
        import time as _time

        n_done = 0
        while self._kf_finish_q and (max_entries is None
                                     or n_done < max_entries):
            pend = self._kf_finish_q[0]
            if not wait:
                aged = (_time.perf_counter() - pend["t_build0"]
                        > self.FORCE_FINISH_S)
                try:
                    if not aged and not pend["ba_diag"].is_ready():
                        return
                except AttributeError:
                    pass
            self._kf_finish_q.popleft()
            self._finish_one(pend)
            n_done += 1

    def _finish_one(self, pend: dict):
        import time as _time

        t_fin0 = _time.perf_counter()
        kf = pend["kf"]
        status = pend["status"]
        stage = pend["stage"]
        active_rec = pend["active_rec"]

        stats = solve.run_ba_fetch(
            pend["ba_diag"],
            (self.cfg.shapes.max_points, self.cfg.shapes.max_frames),
            extra_fetch=pend["act_stats"])
        self.last_idepth_hessian = stats.idepth_hessian
        stage["ba_fetch"] = 1e3 * (_time.perf_counter() - t_fin0)
        act = stats.extra
        n_act = int(act[lifecycle.ST_N_ACT])
        self._last_act_stats = dict(
            n_corner_act=int(act[lifecycle.ST_N_CORNER_ACT]),
            min_act_dist=self._min_act_dist)
        status.update(
            n_imm=int(act[lifecycle.ST_N_IMM]),
            n_imm_good=int(act[lifecycle.ST_N_IMM_GOOD]),
            n_imm_q=int(act[lifecycle.ST_N_IMM_Q]))
        self._refresh_kf_poses(stats.poses, active_rec)
        # exact post-BA ref pose replaces the tracked-estimate the swap
        # installed (same ref_version: the device-side pose was exact all
        # along; only host-side compositions used the estimate)
        with self.state_lock:
            if self.ref_kf == kf.kf_id:
                self._T_ref_cw_np = stats.poses[kf.slot].copy()

        marg_slots = self._flag_frames_for_marginalization(
            stats, active_rec, kf.slot)
        n_goners = self._remove_and_marginalize_points(stats, marg_slots)
        self._n_active_cache = int(act[lifecycle.ST_N_ACTIVE]) - n_goners
        status.update(n_act=n_act,
                      n_drop=n_goners,
                      # photometric-only: the total includes the prior's
                      # quadratic expansion whose constant is dropped
                      # (legitimately negative) — useless as a health metric
                      e_per_res=stats.energy_photo / max(stats.num_residuals, 1),
                      e_prior=stats.energy_final - stats.energy_photo)
        for slot in marg_slots:
            self._marginalize_frame(slot, stats)

        # cull candidates hosted by dying slots (seeding already ran at
        # build time); journaled so concurrent tracing write-backs replay
        if marg_slots:
            dying = np.zeros(self.cfg.shapes.max_frames, dtype=bool)
            for s in marg_slots:
                dying[s] = True
            self._commit_bank_patch(bank_mod.drop_hosted,
                                    jnp.asarray(dying))

        status.update(
            ba_energy=stats.energy_final, ba_iters=stats.iterations,
            n_res=stats.num_residuals, kf_id=kf.kf_id,
            n_window=sum(k is not None for k in self.slot_kf),
            **getattr(self, "_last_act_stats", {}))
        if self.on_keyframe is not None:
            self.on_keyframe(self, kf, pend["pyr"])
        stage["finish"] = 1e3 * (_time.perf_counter() - t_fin0)
        self.kf_ms.append(pend["t_build_ms"] + stage["finish"])
        status["kf_ms"] = self.kf_ms[-1]
        status["kf_stage_ms"] = {k: round(v, 1) for k, v in stage.items()}
        self.kf_stage_ms.append(stage)

    def _free_slot(self) -> Optional[int]:
        """First window slot that is free AND clean (its previous
        occupant's frame fold — if any — already applied to the prior)."""
        with self._prior_lock:
            dirty = set(self._slot_dirty)
        for i, k in enumerate(self.slot_kf):
            if k is None and i not in dirty:
                return i
        return None

    def _new_kf(self, fid, ts, T_cw, img3, exposure, aff_ab) -> KeyframeRecord:
        slot = self._free_slot()
        assert slot is not None, "no clean free window slot (guarded in _make_keyframe)"
        kf = KeyframeRecord(self.next_kf_id, fid, ts,
                            np.asarray(T_cw, dtype=np.float64), slot)
        self.next_kf_id += 1
        self.slot_kf[slot] = kf.kf_id
        with self.state_lock:
            self.kfs[kf.kf_id] = kf
        self.win = win_mod.insert_frame(
            self.win, slot, jnp.asarray(T_cw, jnp.float32), img3,
            exposure, aff_ab=aff_ab)
        return kf

    def _kf_affine(self, kf: KeyframeRecord):
        x = np.asarray(self.win.x[kf.slot])
        return float(x[6]), float(x[7])

    @staticmethod
    def _fold_ready(handle) -> bool:
        try:
            return all(a.is_ready() for a in handle[:5])
        except AttributeError:
            return True

    def _materialize_prior(self, wait: bool = True):
        """Apply deferred marginalization folds to the f64 prior, in
        order. With wait=False only the longest READY prefix is applied
        (order is load-bearing: a frame's Schur-elimination must follow
        the point folds queued before it) — the build path calls this
        non-blocking so an unlanded fold transfer never stalls a
        keyframe; prior USERS (checkpoint, shutdown, slot exhaustion)
        call wait=True. Thread-safe under _prior_lock (advisor r4:
        concurrent materialization double-applied folds)."""
        with self._prior_lock:
            applied = 0
            for entry in self._prior_pending:
                if entry[0] == "points":
                    if not wait and not self._fold_ready(entry[1]):
                        break
                    self.HM, self.bM = marginal.points_fold_apply(
                        entry[1], self.HM, self.bM)
                else:
                    _, slot, aff_prior, aff_delta = entry
                    self.HM, self.bM = marginal.marginalize_frame(
                        slot, self.HM, self.bM, frame_prior_diag=aff_prior,
                        frame_prior_delta=aff_delta)
                    self._slot_dirty.discard(slot)
                applied += 1
            del self._prior_pending[:applied]

    def _run_ba(self, extra_fetch=None, timings=None) -> solve.BAStats:
        self._materialize_prior()
        anchor = self._oldest_slot()
        self.win, stats = solve.run_ba(self.win, self.HM, self.bM, self.cfg,
                                       anchor_slot=anchor,
                                       extra_fetch=extra_fetch,
                                       timings=timings)
        # per-point idepth Hessian at the solution: consumers (loop
        # snapshot depth transfer, marginalize-vs-drop gate) use it as
        # the "depth actually observable" signal (reference:
        # PointHessian::idepth_hessian)
        self.last_idepth_hessian = stats.idepth_hessian
        return stats

    def _oldest_slot(self) -> int:
        act = [(kid, s) for s, kid in enumerate(self.slot_kf) if kid is not None]
        return min(act)[1] if act else 0

    def _refresh_kf_poses(self, poses: Optional[np.ndarray] = None,
                          active_rec: Optional[list] = None):
        """Write BA poses back to the host records. ``active_rec`` (the
        (kf_id, slot) list captured at that BA's dispatch) restricts the
        write to frames the BA actually solved — a deferred finish may
        run AFTER newer keyframes were inserted into other slots, whose
        rows in ``poses`` are stale."""
        T = (np.asarray(poses, dtype=np.float64) if poses is not None
             else np.asarray(self.win.current_pose(), dtype=np.float64))
        rec = (active_rec if active_rec is not None
               else [(kid, s) for s, kid in enumerate(self.slot_kf)
                     if kid is not None])
        with self.state_lock:
            for kid, slot in rec:
                if self.slot_kf[slot] == kid:
                    self.kfs[kid].T_cw = T[slot]

    # ------------------------------------------------------------------
    # Window management (reference: flagFramesForMarginalization)
    # ------------------------------------------------------------------

    def _flag_frames_for_marginalization(self, stats: solve.BAStats,
                                         active_rec: List[tuple],
                                         newest_slot: int) -> List[int]:
        """Reference: flagFramesForMarginalization. Runs in the DEFERRED
        finish of the keyframe whose BA produced ``stats``; by then newer
        keyframes may already occupy other slots, so every rule reads
        only (a) frames present at that BA (``active_rec``) that are
        still in the window, via their slot-aligned ``stats`` rows, and
        (b) the CURRENT occupancy count, so deferred finishes still
        shrink the window back to max_kf. Frames newer than this BA are
        never flagged (their stats rows are stale/garbage)."""
        cfg = self.cfg
        current = [(kid, s) for s, kid in enumerate(self.slot_kf)
                   if kid is not None]
        current.sort()
        if len(current) <= cfg.window.max_kf:
            return []
        newest2 = {s for _, s in current[-2:]}
        # flag candidates: solved by this BA, still present, not newest
        cand = [s for kid, s in sorted(active_rec)
                if self.slot_kf[s] == kid and s not in newest2
                and s != newest_slot]

        p_host = stats.p_host
        p_valid = stats.p_valid
        vp = stats.valid_pair if stats.valid_pair is not None else None

        flagged: List[int] = []
        n_keep = len(current)
        # rule 1: drop frames with almost no points visible in the newest KF
        # or a large affine gap to it (reference: <5% in-view, maxLogAffFac)
        x = stats.x
        for s in cand:
            if n_keep - len(flagged) <= cfg.window.min_kf:
                continue
            hosted = p_valid & (p_host == s)
            n_hosted = int(hosted.sum())
            vis = (int((vp[:, newest_slot] & hosted).sum()) / n_hosted
                   if (vp is not None and n_hosted > 0) else 1.0)
            aff_gap = abs(float(x[s, 6] - x[newest_slot, 6]))
            if n_hosted == 0 or vis < cfg.window.min_inlier_visible_frac \
                    or aff_gap > cfg.window.max_log_aff_fac:
                flagged.append(s)
        # rule 2: spatial-spread heuristic — drop the frame crowded among
        # the others but far from the newest
        T = np.asarray(stats.poses, dtype=np.float64)
        while n_keep - len(flagged) > cfg.window.max_kf:
            centers = {s: -T[s, :3, :3].T @ T[s, :3, 3] for s in cand}
            centers[newest_slot] = (-T[newest_slot, :3, :3].T
                                    @ T[newest_slot, :3, 3])
            best, best_score = None, -np.inf
            for s in cand:
                if s in flagged:
                    continue
                d_new = np.linalg.norm(centers[s] - centers[newest_slot])
                crowd = sum(1.0 / (1e-5 + np.linalg.norm(centers[s] - centers[o]))
                            for o in cand if o != s and o not in flagged)
                score = np.sqrt(d_new) * crowd
                if score > best_score:
                    best, best_score = s, score
            if best is None:
                break
            flagged.append(best)
        return flagged

    def _remove_and_marginalize_points(self, stats: solve.BAStats,
                                       marg_slots: List[int]) -> int:
        """Points that lost their residuals or whose host dies: fold the
        well-constrained ones into the prior, drop the rest (reference:
        flagPointsForRemoval + ef->marginalizePointsF/dropPointsF).
        Works entirely off the packed BA readback; returns # removed."""
        cfg = self.cfg
        p_valid = stats.p_valid
        p_host = stats.p_host
        res_mask = stats.res_mask
        res_rows = res_mask.sum(axis=1)
        dying_host = np.isin(p_host, marg_slots) & p_valid
        no_res = (res_rows == 0) & p_valid
        goners = dying_host | no_res
        if not goners.any():
            return 0
        # rows the device BA tail already retired in-program (junk: no
        # residuals + fail the marginalize gates): count them as removed
        # but do NOT touch their window slots again — by the time this
        # deferred finish runs, activation may have re-filled them
        junk = (stats.junk if stats.junk is not None
                else np.zeros_like(goners))
        hdd = stats.idepth_hessian if stats.idepth_hessian is not None \
            else np.zeros(len(p_valid))
        # maxRelBaseline gate (reference: PointHessian::maxRelBaseline —
        # only points observed with enough relative baseline × idepth are
        # well-triangulated enough to fold into the prior; the rest drop)
        T = np.asarray(stats.poses, dtype=np.float64)
        C = -np.einsum("fji,fj->fi", T[:, :3, :3], T[:, :3, 3])   # camera centers
        dist = np.linalg.norm(C[p_host][:, None, :] - C[None, :, :], axis=-1)
        rel_b = np.max(np.where(res_mask, dist, 0.0), axis=1) \
            * stats.p_idepth
        marg_mask = goners & (hdd > cfg.ba.min_idepth_hessian) \
            & (rel_b > cfg.ba.min_rel_baseline)
        # archive well-constrained dying points into the persistent map
        # before they leave the window (reference: src/Map.cc keeps the
        # exposed Point layer alive past marginalization)
        self._archive_map_points(stats, goners & (hdd > cfg.ba.min_idepth_hessian))
        if marg_mask.any():
            # DEFERRED fold: dispatch the FEJ assembly + async copies
            # now, apply the f64 update at the next prior use — the
            # blocking pull sat behind the whole pipelined device queue
            # (70 ms - 2.5 s per marginalizing KF measured)
            with self._prior_lock:
                self._prior_pending.append(
                    ("points", marginal.points_fold_start(self.win, marg_mask,
                                                          cfg)))
        self.win = win_mod.drop_points(self.win, jnp.asarray(goners & ~junk))
        return int(goners.sum())

    def _archive_map_points(self, stats: solve.BAStats, mask: np.ndarray):
        """Snapshot dying points into the persistent global map, in
        host-camera coordinates grouped by host kf_id. Uses only the
        packed BA readback — zero extra device traffic."""
        if not mask.any() or stats.p_uv is None:
            return
        uv = stats.p_uv[mask]
        idep = np.maximum(stats.p_idepth[mask], 1e-6)
        color = stats.p_color[mask] if stats.p_color is not None \
            else np.full(mask.sum(), 200.0)
        hosts = stats.p_host[mask]
        fx, fy, cx, cy = (float(v) for v in stats.c)
        z = 1.0 / idep
        xyz = np.stack([(uv[:, 0] - cx) / fx * z,
                        (uv[:, 1] - cy) / fy * z, z], axis=-1)
        with self.state_lock:
            for s in np.unique(hosts):
                kid = self.slot_kf[s]
                if kid is None:
                    continue
                m = hosts == s
                prev = self.map_points.get(kid)
                if prev is None:
                    self.map_points[kid] = dict(xyz_cam=xyz[m],
                                                color=color[m])
                else:
                    prev["xyz_cam"] = np.concatenate(
                        [prev["xyz_cam"], xyz[m]])
                    prev["color"] = np.concatenate([prev["color"], color[m]])

    def global_map_points(self, include_window: bool = True):
        """World point cloud of the persistent map (+ optionally the live
        window), composed through each KF's latest pose-graph-optimized
        Sim3 (reference: Map.cc::OptimizeALLKFs refreshes every Point's
        world position; here positions are derived lazily so they are
        ALWAYS current). Returns (xyz [N,3], intensity [N])."""
        xyz_out, col_out = [], []
        with self.state_lock:
            arch = [(kid, d["xyz_cam"].copy(), d["color"].copy(),
                     self.kfs[kid].S_cw_opti if self.kfs[kid].S_cw_opti
                     is not None else self.kfs[kid].T_cw)
                    for kid, d in self.map_points.items() if kid in self.kfs]
        for _, xc, col, S_cw in arch:
            S_wc = np.linalg.inv(np.asarray(S_cw, np.float64))
            xyz_out.append(xc @ S_wc[:3, :3].T + S_wc[:3, 3])
            col_out.append(col)
        if include_window:
            win = self.win
            snap = jax.device_get(dict(
                T=win.current_pose(), v=win.p_valid, uv=win.p_uv,
                d=win.p_idepth, host=win.p_host, col=win.p_color[:, 4],
                c=win.c))
            idx = np.flatnonzero(snap["v"])
            if len(idx):
                fx, fy, cx, cy = (float(v) for v in snap["c"])
                z = 1.0 / np.maximum(snap["d"][idx], 1e-6)
                Xc = np.stack([(snap["uv"][idx, 0] - cx) / fx * z,
                               (snap["uv"][idx, 1] - cy) / fy * z, z], -1)
                T = np.asarray(snap["T"], np.float64)[snap["host"][idx]]
                xyz_out.append(np.einsum("pji,pj->pi", T[:, :3, :3],
                                         Xc - T[:, :3, 3]))
                col_out.append(snap["col"][idx])
        if not xyz_out:
            return np.zeros((0, 3)), np.zeros(0)
        return np.concatenate(xyz_out), np.concatenate(col_out)

    def _marginalize_frame(self, slot: int, stats: solve.BAStats):
        cfg = self.cfg
        kid = self.slot_kf[slot]
        kf = self.kfs[kid]
        T = np.asarray(stats.poses, dtype=np.float64)
        others = sorted((self.slot_kf[s], s) for s in range(len(self.slot_kf))
                        if self.slot_kf[s] is not None and s != slot)
        with self.state_lock:
            kf.T_cw = T[slot]
            kf.in_window = False
            kf.slot = -1
            # pose-graph odometry edges to the KFs still in the window
            # (reference: Frame::poseRel recorded at marginalization)
            for okid, oslot in others[: cfg.loop.max_edges_per_kf]:
                T_ab = T[slot] @ np.linalg.inv(T[oslot])
                self.pose_edges.append(PoseEdge(kid, okid, T_ab, "odom"))

        aff_prior = np.array([0.0] * 6 + [cfg.ba.affine_prior_a,
                                          cfg.ba.affine_prior_b])
        # the diagonal prior pins ABSOLUTE a,b to zero (ba/solve.py
        # prior_offset): in delta coordinates its gradient at Δ=0 is
        # λ·x_zero — the fold convention bM := ∂E/∂Δ|_{Δ=0}
        aff_delta = np.asarray(stats.x_zero[slot], dtype=np.float64)
        aff_delta[:6] = 0.0
        # deferred with the point folds (strict order preserved in the
        # pending queue; the window/bookkeeping update happens NOW). The
        # slot is DIRTY until the fold applies — _new_kf must not reuse
        # it (the fold would Schur-eliminate the new occupant's block)
        with self._prior_lock:
            self._prior_pending.append(("frame", slot, aff_prior, aff_delta))
            self._slot_dirty.add(slot)
        self.win = win_mod.remove_frame(self.win, slot)
        self.slot_kf[slot] = None

    # ------------------------------------------------------------------
    # Immature-point lifecycle (reference: traceNewCoarse, activatePointsMT,
    # makeNewTraces)
    # ------------------------------------------------------------------

    def _trace_immatures(self, img3_new, T_new_cw, exposure, aff_ab):
        """Epipolar-trace the device bank against the new frame — one
        dispatch, zero host traffic (reference: traceNewCoarse)."""
        self.bank = frame_step.trace_step(
            img3_new, self.bank, self.win.T_eval, self.win.x,
            self.win.exposure, jnp.asarray(T_new_cw, jnp.float32),
            jnp.asarray(aff_ab, jnp.float32), jnp.float32(exposure),
            self.intr_j, self.cfg)

    def _update_min_act_dist(self) -> float:
        """Adaptive activation-spacing ladder (reference: the
        currentMinActDist feedback in activatePointsMT): the radius
        grows when the window is over-full and shrinks when starved.
        Sequential scalar state — stays on the host; the device
        activation program receives the resulting cell size. Returns
        the occupancy-cell size in pixels (2·mad)."""
        cfg = self.cfg
        n_now = float(self._n_active_cache)
        desired = min(cfg.selector.desired_point_density,
                      float(cfg.shapes.max_points))
        mad = self._min_act_dist
        if n_now < desired * 0.66:
            mad -= 0.8
        elif n_now < desired * 0.8:
            mad -= 0.5
        elif n_now < desired * 0.9:
            mad -= 0.2
        if n_now > desired:
            mad += 0.2
        self._min_act_dist = mad = float(np.clip(mad, 0.0, 4.0))
        return 2.0 * mad

    def _dispatch_seed(self, pyr, fid: int):
        """Dispatch the candidate-seed program (non-blocking); its
        outputs stay on device — compute_seed_patch consumes them there
        (reference: makeNewTraces = FeatureDetector + PixelSelector).
        The dither seed comes from the keyframe's own frame id (fid + 1
        is the frame count when it was submitted), not the live count,
        which the tracking thread advances while an async build runs."""
        cfg = self.cfg
        return _seed_program(pyr[0], pyr[1], pyr[2], cfg,
                             seed=int(cfg.seed + ((fid + 1) & 3)))

    def _seed_new_kf(self, slot: int, seed_fut):
        """Device-side candidate reseed for a keyframe: merge corner +
        gradient picks, scatter into free bank slots — committed as a
        journaled patch."""
        dying = np.zeros(self.cfg.shapes.max_frames, dtype=bool)
        with self.state_lock:
            bank_dev = self.bank
        drop, slots, s_uv, s_col, s_wgt, s_corner = \
            lifecycle.compute_seed_patch(bank_dev, seed_fut, jnp.int32(slot),
                                         jnp.asarray(dying), self.cfg)
        self._commit_bank_patch(bank_mod.apply_patch, drop, slots, s_uv,
                                s_col, s_wgt, jnp.int32(slot), s_corner)

    # ------------------------------------------------------------------
    # Tracker reference (reference: setCoarseTrackingRef + makeCoarseDepthL0)
    # ------------------------------------------------------------------

    def _swap_tracker_ref_device(self, kf: KeyframeRecord):
        """Swap the tracking reference to the post-BA DEVICE state of
        the new keyframe — all inputs are device futures, so the swap
        needs no readback and frames dispatched immediately after it
        already track against the refined new KF. The host-side pose
        bookkeeping uses the tracked estimate until _finish_kf patches
        in the exact BA pose (device-side values are exact throughout)."""
        slot = jnp.asarray(kf.slot)
        uv, idep, color, valid = _project_points_to_slot(self.win, slot)
        new_ref = tracker.make_tracker_ref(
            uv, idep, color, valid, self.cfg.shapes.pyr_levels,
            exposure=self.win.exposure[kf.slot],
            aff_ab=self.win.x[kf.slot, 6:8])
        T_ref_dev = self.win.current_pose(kf.slot)
        with self.state_lock:
            self.track_ref = new_ref
            self.ref_kf = kf.kf_id
            self._T_ref_cw_np = np.asarray(kf.T_cw, np.float64).copy()
            self._T_ref_cw_dev = T_ref_dev
            self._ref_version += 1
        self.last_rel_ab = np.zeros(2, dtype=np.float32)

    def _update_tracker_ref(self, kf: KeyframeRecord,
                            stats: Optional[solve.BAStats] = None):
        uv, idep, color, valid = _project_points_to_slot(
            self.win, jnp.asarray(kf.slot))
        if stats is not None:       # KF path: values ride the BA readback
            expo = float(stats.exposure[kf.slot])
            aff = (float(stats.x[kf.slot, 6]), float(stats.x[kf.slot, 7]))
        else:                       # init/sync path: one-off readbacks
            expo = float(self.win.exposure[kf.slot])
            aff = self._kf_affine(kf)
        new_ref = tracker.make_tracker_ref(
            uv, idep, color, valid, self.cfg.shapes.pyr_levels,
            exposure=expo, aff_ab=aff)
        # atomic swap of the ref bundle (async: mapping thread writes,
        # tracking thread reads — reference: setCoarseTrackingRef mutex)
        with self.state_lock:
            self.track_ref = new_ref
            self.ref_kf = kf.kf_id
            self._T_ref_cw_np = np.asarray(kf.T_cw, np.float64).copy()
            self._T_ref_cw_dev = jnp.asarray(self._T_ref_cw_np, jnp.float32)
            self._ref_version += 1
        self.last_rel_ab = np.zeros(2, dtype=np.float32)
