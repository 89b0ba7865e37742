"""Loop detection + correction orchestration.

JAX redesign of the reference's ``LoopClosing`` thread
(reference: n-lalanne/LDSO src/frontend/LoopClosing.cc — per-KF BoW
insert, DetectLoop's score gates + consistency window, geometric check
via PnP-RANSAC + g2o Sim3 refine, then Map::OptimizeALLKFs in a
detached thread): here the host conductor is synchronous-by-default
(call per keyframe), with every numeric stage jitted — feature
detection, BoW assignment/scoring, Hamming matching, batched Sim3
RANSAC, GN refine, and the CG pose graph. The async overlap of the
reference's thread model is recovered at the device level: these
programs run on the accelerator stream while the host continues
(dispatch is non-blocking until results are read).

Point depth for matched features comes from the engine's active point
banks at keyframe time — each KF snapshot stores (uv, idepth) of its
visible active points and feature depths are assigned by
nearest-active-point lookup (the reference reads immature/active depth
around the corner the same way).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ldso_tpu.config import LdsoConfig
from ldso_tpu.loop import bow, match, orb, posegraph, sim3
from ldso_tpu.math import lie


@dataclasses.dataclass
class KFSnapshot:
    """Per-keyframe loop-closure payload (reference: Frame's features,
    bowVec, and the depth its corners inherit from nearby points)."""

    kf_id: int
    feats: orb.Features
    bow_vec: Optional[np.ndarray]      # None until the vocabulary exists
    # features with depth (camera-frame 3D), for geometric verification
    X_cam: np.ndarray                  # [N, 3]
    has_depth: np.ndarray              # bool [N]


def _assign_depth(feat_uv: np.ndarray, pt_uv: np.ndarray,
                  pt_idepth: np.ndarray, pt_valid: np.ndarray,
                  intr, max_px: float = 8.0):
    """Nearest-active-point depth transfer to corner features."""
    n = feat_uv.shape[0]
    X = np.zeros((n, 3), np.float64)
    ok = np.zeros(n, bool)
    pu = pt_uv[pt_valid]
    pd = pt_idepth[pt_valid]
    if len(pu) == 0:
        return X, ok
    d2 = ((feat_uv[:, None, :] - pu[None, :, :]) ** 2).sum(-1)
    j = d2.argmin(1)
    near = np.sqrt(d2[np.arange(n), j]) < max_px
    idep = np.maximum(pd[j], 1e-6)
    fx, fy, cx, cy = (float(v) for v in intr)
    z = 1.0 / idep
    X[:, 0] = (feat_uv[:, 0] - cx) / fx * z
    X[:, 1] = (feat_uv[:, 1] - cy) / fy * z
    X[:, 2] = z
    ok = near
    return X, ok


class LoopClosing:
    """Host conductor for loop closure; attach via
    ``full_system.on_keyframe = LoopClosing(cfg, intr).on_keyframe``."""

    def __init__(self, cfg: LdsoConfig, intr,
                 vocab: Optional[bow.Vocabulary] = None,
                 train_after: int = 8):
        import threading

        self.cfg = cfg
        self.intr = np.asarray(intr, np.float32)
        self.vocab = vocab
        self.train_after = train_after
        self.db: Optional[bow.KeyframeDatabase] = (
            bow.KeyframeDatabase(vocab) if vocab is not None else None)
        self.snapshots: dict[int, KFSnapshot] = {}
        self.loops_closed: List[tuple] = []    # (kf_cur, kf_cand, S_cur_cand)
        # consistency groups (reference: DetectLoop's mvConsistentGroups —
        # MULTIPLE concurrent groups, each the covisible region of a past
        # candidate with the length of the chain of consecutive recent
        # KFs that proposed an overlapping region; single-group tracking
        # reset the chain whenever two true-loop regions alternated)
        self._consistent_groups: List[tuple] = []   # (frozenset[kf_id], count)
        self.rejected: List[dict] = []         # gate decisions (diagnostics)
        self._trained_on = 0                   # descriptor count at last train
        self._key = jax.random.PRNGKey(cfg.seed)
        # vocabulary swap guard: retrains run on a background thread and
        # swap (vocab, db, snapshot signatures) atomically under this
        # lock — detection NEVER blocks on a retrain (the round-3 worker
        # re-encoded the whole map inline: an O(map) detection outage
        # exactly when loops matter)
        self._vocab_lock = threading.Lock()
        self._retrain_thread: Optional[threading.Thread] = None
        # failed background retrains, (exc_name, traceback) — surfaced to
        # tests/operators instead of silently keeping the old tree
        self.retrain_errors: List[tuple] = []

    # ------------------------------------------------------------------

    def on_keyframe(self, system, kf, pyr) -> Optional[dict]:
        """Per-new-KF hook (reference: InsertKeyFrame + Run loop body).

        Synchronous variant: detect + close inline. The async variant
        (:class:`AsyncLoopClosing`) snapshots the same inputs and runs
        :meth:`_process` on a worker thread."""
        win, slot = system.win, kf.slot      # consistent snapshot (pytree ref)
        return self._process(system, kf, pyr[0], win, slot, system.bank)

    @staticmethod
    def _immature_depth_sources(win, bank, slot):
        """Project converged immature candidates into ``slot``'s frame —
        extra (uv, idepth) depth sources for feature-depth transfer (the
        reference reads immature AND active depths around each corner;
        active points alone starve the transfer on low-parallax legs)."""
        from ldso_tpu import trace as trace_mod

        v = np.asarray(bank.valid)
        st = np.asarray(bank.last_status)
        d_min = np.asarray(bank.idepth_min)
        d_max = np.asarray(bank.idepth_max)
        mid = 0.5 * (d_min + d_max)
        conv = (v & (st == trace_mod.GOOD) & np.isfinite(d_max)
                & (mid > 1e-4) & ((d_max - d_min) < 0.1 * np.maximum(mid, 1e-4)))
        if not conv.any():
            return np.zeros((0, 2), np.float32), np.zeros(0, np.float32)
        host = np.asarray(bank.host_slot)[conv]
        uv = np.asarray(bank.uv)[conv]
        d0 = mid[conv]
        T = np.asarray(win.current_pose(), np.float64)
        fx, fy, cx, cy = (float(x) for x in np.asarray(win.c))
        T_rel = np.einsum("ij,pjk->pik", T[slot], np.linalg.inv(T)[host])
        xh = np.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy,
                       np.ones(len(uv))], axis=-1)
        Xc = np.einsum("pij,pj->pi", T_rel[:, :3, :3], xh) \
            + T_rel[:, :3, 3] * d0[:, None]
        z = Xc[:, 2]
        okz = z > 1e-6
        zs = np.where(okz, z, 1.0)
        uvn = np.stack([fx * Xc[:, 0] / zs + cx, fy * Xc[:, 1] / zs + cy],
                       axis=-1).astype(np.float32)
        return uvn[okz], (d0 / zs)[okz].astype(np.float32)

    def _process(self, system, kf, pyr0, win, slot, bank=None) -> Optional[dict]:
        cfg = self.cfg
        feats = orb.detect(pyr0, max_features=cfg.loop.max_features,
                           fast_th=cfg.loop.orb_fast_th)
        uv_np = np.asarray(feats.uv)
        pt_uv, pt_idep, _, pt_valid = (np.asarray(a) for a in
                                       self._points_in_kf(win, slot))
        # only WELL-CONSTRAINED depths may back loop geometry: points
        # whose idepth Hessian is weak (low-parallax, e.g. a distant
        # backdrop) carry map-inconsistent depths that poison the Sim3
        # scale estimate (reference: idepth_hessian gates throughout)
        hdd = getattr(system, "last_idepth_hessian", None)
        if hdd is not None and len(hdd) == len(pt_valid):
            pt_valid = pt_valid & (hdd > 20.0 * cfg.ba.min_idepth_hessian)
        pt_uv, pt_idep = pt_uv[pt_valid], pt_idep[pt_valid]
        if bank is not None:
            im_uv, im_idep = self._immature_depth_sources(win, bank, slot)
            pt_uv = np.concatenate([pt_uv, im_uv])
            pt_idep = np.concatenate([pt_idep, im_idep])
        pt_valid = np.ones(len(pt_uv), bool)
        X, ok = _assign_depth(uv_np, pt_uv, pt_idep, pt_valid, self.intr)
        ok &= np.asarray(feats.valid)
        snap = KFSnapshot(kf.kf_id, feats, None, X, ok)
        with self._vocab_lock:       # retrain thread iterates snapshots
            self.snapshots[kf.kf_id] = snap

        # lazily train the vocabulary once enough descriptors exist, and
        # RETRAIN at a larger tree size as the corpus grows (reference:
        # the 10⁶-leaf pre-trained orbvoc.dbow3 — offline here, so the
        # tree is grown incrementally: 8³ → 10³ → 10⁴ → 10⁵ leaves). The
        # FIRST train is synchronous (nothing to detect with until it
        # exists); every ladder retrain runs on a background thread and
        # swaps in atomically — detection continues on the old tree
        if self.vocab is None:
            if len(self.snapshots) >= self.train_after:
                self._train_vocab()
            return None
        n_desc = sum(int(np.asarray(s.feats.valid).sum())
                     for s in self.snapshots.values())
        if n_desc >= 4 * max(self._trained_on, 1) \
                and self._vocab_shape(n_desc) != (self.vocab.k,
                                                  self.vocab.levels):
            self._start_retrain()

        with self._vocab_lock:
            vocab, db = self.vocab, self.db
        snap.bow_vec = np.asarray(
            bow.bow_vector(vocab, feats.desc, feats.valid))
        result = self._detect_and_close(system, kf, snap)
        with self._vocab_lock:
            if self.db is db:                  # no swap since the query
                db.add(kf.kf_id, snap.bow_vec)
            else:                              # swapped mid-detection:
                snap.bow_vec = np.asarray(     # re-encode with the new tree
                    bow.bow_vector(self.vocab, feats.desc, feats.valid))
                self.db.add(kf.kf_id, snap.bow_vec)
        if result is not None and not result.get("accepted", False):
            self.rejected.append(result)
        return result

    def _points_in_kf(self, win, slot):
        from ldso_tpu.system import _project_points_to_slot
        return _project_points_to_slot(win, jnp.asarray(slot))

    @staticmethod
    def _vocab_shape(n_desc: int):
        """(k, levels) ladder by corpus size — larger corpora earn finer
        trees (reference vocabulary: k=10, L=5/6 ≈ 10⁵-10⁶ leaves,
        trained on millions of descriptors)."""
        if n_desc >= 300_000:
            return 10, 5            # 10⁵ leaves (KITTI-00 scale)
        if n_desc >= 30_000:
            return 10, 4            # 10⁴ leaves
        if n_desc >= 5_000:
            return 10, 3            # 10³ leaves
        return 8, 3                 # 512 leaves (small-corpus bootstrap)

    def _collect_descs(self, snaps):
        descs, valids = [], []
        for s in snaps:
            descs.append(np.asarray(s.feats.desc))
            valids.append(np.asarray(s.feats.valid))
        return np.concatenate(descs)[np.concatenate(valids)]

    def _train_vocab(self):
        """Train + re-encode + atomic swap (called synchronously for the
        first train, from the retrain thread afterwards)."""
        # snapshot list copied UNDER the lock: the detection thread
        # inserts concurrently, and list(dict.values()) during a resize
        # can raise RuntimeError (advisor r4)
        with self._vocab_lock:
            snaps = sorted(self.snapshots.values(), key=lambda x: x.kf_id)
        d = self._collect_descs(snaps)
        k, levels = self._vocab_shape(len(d))
        vocab = bow.train_vocabulary(d, k=k, levels=levels,
                                     seed=self.cfg.seed)
        db = bow.KeyframeDatabase(vocab)
        encoded = {}
        for s in snaps:
            encoded[s.kf_id] = np.asarray(
                bow.bow_vector(vocab, s.feats.desc, s.feats.valid))
            db.add(s.kf_id, encoded[s.kf_id])
        with self._vocab_lock:
            # snapshots that arrived during the (background) train get
            # re-encoded here — a handful, not the whole map
            for s in list(self.snapshots.values()):
                if s.kf_id not in encoded and s.bow_vec is not None:
                    encoded[s.kf_id] = np.asarray(
                        bow.bow_vector(vocab, s.feats.desc, s.feats.valid))
                    db.add(s.kf_id, encoded[s.kf_id])
            self.vocab, self.db = vocab, db
            self._trained_on = len(d)
            for kid, vec in encoded.items():
                if kid in self.snapshots:
                    self.snapshots[kid].bow_vec = vec

    def _start_retrain(self):
        """Ladder retrain on a background thread; atomic swap at the end
        (reference analog: the pre-trained vocabulary never retrains —
        growing one online must not stall DetectLoop)."""
        import threading

        if self._retrain_thread is not None and self._retrain_thread.is_alive():
            return

        def worker():
            try:
                self._train_vocab()   # trains + re-encodes + atomic swap
            except Exception as e:    # a failed retrain keeps the old tree
                # recorded, not swallowed: a silent cancel would also
                # hide genuine training bugs (advisor r4)
                import traceback

                self.retrain_errors.append(
                    (type(e).__name__, traceback.format_exc()))

        self._retrain_thread = threading.Thread(
            target=worker, name="ldso-vocab-retrain", daemon=True)
        self._retrain_thread.start()

    def finish_retrain(self):
        """Block until a background retrain completes (tests/shutdown)."""
        t = self._retrain_thread
        if t is not None:
            t.join(timeout=120.0)

    # ------------------------------------------------------------------

    def _detect_and_close(self, system, kf, snap) -> Optional[dict]:
        """reference: DetectLoop + CorrectLoop."""
        cfg = self.cfg
        if len(self.db) == 0:
            return None
        ids, scores = self.db.query(
            snap.bow_vec, exclude_above=kf.kf_id - cfg.loop.min_kf_gap)
        if len(ids) == 0:
            return None
        # covisible-group score floor (reference: DetectLoop computes
        # minScore as the MINIMUM BoW similarity between the current KF
        # and its covisible neighbors — here the odometry window — and
        # only candidates scoring above it survive; the round-2
        # prev-KF-only floor collapsed under viewpoint change)
        neigh_vecs = []
        if system is not None:
            with system.state_lock:
                win_ids = [k for k in system.slot_kf
                           if k is not None and k != kf.kf_id]
            neigh_vecs = [self.snapshots[k].bow_vec for k in win_ids
                          if k in self.snapshots
                          and self.snapshots[k].bow_vec is not None]
        if not neigh_vecs:
            prev = self.snapshots.get(kf.kf_id - 1)
            if prev is not None and prev.bow_vec is not None:
                neigh_vecs = [prev.bow_vec]
        ref_score = 0.1
        if neigh_vecs:
            sc = np.asarray(bow.l1_score(jnp.asarray(snap.bow_vec),
                                         jnp.asarray(np.stack(neigh_vecs))))
            ref_score = float(sc.min())
        th = max(0.05, cfg.loop.min_score_rel * ref_score)
        order = np.argsort(-np.asarray(scores))
        cands = [(int(ids[i]), float(scores[i])) for i in order[:5]
                 if scores[i] >= th]
        if not cands:
            self._consistent_groups = []
            return None
        # consistency groups (reference: DetectLoop's mvConsistentGroups):
        # EVERY above-threshold candidate's neighborhood (temporally
        # adjacent KF ids — the proxy for its covisible group) extends
        # any overlapping group from previous keyframes; groups not
        # refreshed this round are pruned. A candidate whose chain
        # reaches `consistency_window` earns a geometry check. Multiple
        # concurrent groups let two alternating true-loop regions both
        # mature (single-group tracking reset the chain every time the
        # best-scoring region flipped — a recall regression).
        new_groups: List[tuple] = []
        ready: List[tuple] = []
        for cand_id, sc in cands:
            cand_group = frozenset(
                c for c in range(cand_id - 3, cand_id + 4)
                if c in self.snapshots)
            chain = 1
            for grp, cnt in self._consistent_groups:
                if cand_group & grp:
                    chain = max(chain, cnt + 1)
            new_groups.append((cand_group, chain))
            if chain >= cfg.loop.consistency_window:
                ready.append((cand_id, sc, chain))
        self._consistent_groups = new_groups
        if not ready:
            return dict(candidate=cands[0][0], score=cands[0][1],
                        accepted=False, reason="consistency",
                        chain=max(c for _, c in new_groups))

        # geometry-check the matured candidates best-first; the first
        # one that passes closes the loop (reference: CorrectLoop walks
        # the enough-consistent candidates the same way)
        result = None
        for cand_id, sc, _ in ready:
            result = self._geometric_check(system, kf, snap, cand_id, sc)
            if result.get("accepted", False):
                return result
        return result

    def _geometric_check(self, system, kf, snap, cand_id, score):
        """PnP-first geometric verification (reference flow: matched
        candidate 3D points → cv::solvePnPRansac for the SE3 seed, then
        the Sim(3) refine with reprojection residuals on BOTH frames,
        LoopClosing.cc:~L150). Scale comes from the two-sided-depth
        subset; with too few such pairs the edge falls back to scale 1."""
        cfg = self.cfg
        cand = self.snapshots[cand_id]
        m = match.match(snap.feats.desc, snap.feats.valid,
                        cand.feats.desc, cand.feats.valid)
        m_valid = np.asarray(m.valid)
        idx_b = np.asarray(m.idx_b)
        # PnP needs candidate-side depth only (reference: candidate KF's
        # matched features with valid depth become the 3D points)
        pair_pnp = m_valid & cand.has_depth[idx_b]
        if pair_pnp.sum() < cfg.loop.min_matches:
            return dict(candidate=cand_id, score=score, accepted=False,
                        reason="matches", n=int(pair_pnp.sum()))

        X_a = jnp.asarray(snap.X_cam, jnp.float32)
        uv_a = snap.feats.uv
        X_b = jnp.asarray(cand.X_cam[idx_b], jnp.float32)
        uv_b = cand.feats.uv[jnp.asarray(idx_b)]

        self._key, sub = jax.random.split(self._key)
        r = sim3.ransac_pnp(X_b, uv_a, jnp.asarray(pair_pnp),
                            jnp.asarray(self.intr), sub,
                            n_hyps=cfg.loop.ransac_hypotheses,
                            threshold=cfg.loop.ransac_threshold)
        if int(r.n_inliers) < cfg.loop.min_inliers:
            return dict(candidate=cand_id, score=score, accepted=False,
                        reason="ransac", n_inliers=int(r.n_inliers))

        # Sim3 refine over the two-sided-depth inlier subset
        pair_both = pair_pnp & snap.has_depth
        two_sided = np.asarray(r.inliers) & pair_both
        if two_sided.sum() >= max(8, cfg.loop.min_inliers // 2):
            rf = sim3.refine_sim3(r.S_ab, X_a, uv_a, X_b, uv_b,
                                  jnp.asarray(two_sided),
                                  jnp.asarray(pair_both),
                                  jnp.asarray(self.intr),
                                  iters=cfg.loop.sim3_iterations)
            if int(rf.n_inliers) < max(6, cfg.loop.min_inliers // 2):
                return dict(candidate=cand_id, score=score, accepted=False,
                            reason="refine", n_inliers=int(rf.n_inliers))
        else:
            # scale-1 fallback: refine the SE3 on the PnP inliers
            rf = sim3.refine_pnp(r.S_ab, X_b, uv_a, r.inliers,
                                 jnp.asarray(pair_pnp),
                                 jnp.asarray(self.intr),
                                 iters=cfg.loop.sim3_iterations)
            if int(rf.n_inliers) < cfg.loop.min_inliers:
                return dict(candidate=cand_id, score=score, accepted=False,
                            reason="refine", n_inliers=int(rf.n_inliers))

        # S_cur_cand maps candidate-camera points into current camera:
        # as a pose constraint, S_cur_w = S_cur_cand · S_cand_w
        S_cur_cand = np.asarray(rf.S_ab, np.float64)
        from ldso_tpu.system import PoseEdge
        with system.state_lock:
            system.pose_edges.append(PoseEdge(
                kf.kf_id, cand_id, S_cur_cand, kind="loop",
                scale=float(lie.sim3_scale(jnp.asarray(S_cur_cand)))))
        self.loops_closed.append((kf.kf_id, cand_id, S_cur_cand))
        self._consistent_groups = []

        self.run_pose_graph(system)
        return dict(candidate=cand_id, score=score, accepted=True,
                    n_inliers=int(rf.n_inliers))

    # ------------------------------------------------------------------

    def relocalize(self, system, pyr) -> Optional[dict]:
        """Lost-tracking recovery: BoW query against the whole KF database,
        geometric (Sim3) verification against the best candidate, and
        re-anchoring of the tracker on it. The reference has the database
        but never implements this (SURVEY.md §5.3 — `isLost` just stops
        mapping); config 4 requires it, and it is a natural extension of
        the loop machinery."""
        cfg = self.cfg
        if self.vocab is None or len(self.db) == 0:
            return None
        feats = orb.detect(pyr[0], max_features=cfg.loop.max_features,
                           fast_th=cfg.loop.orb_fast_th)
        bv = np.asarray(bow.bow_vector(self.vocab, feats.desc, feats.valid))
        ids, scores = self.db.query(bv)
        if len(ids) == 0:
            return None
        order = np.argsort(-scores)[:3]
        for oi in order:
            cand_id = int(ids[oi])
            cand = self.snapshots.get(cand_id)
            if cand is None or not cand.has_depth.any():
                continue
            m = match.match(feats.desc, feats.valid,
                            cand.feats.desc, cand.feats.valid)
            idx_b = np.asarray(m.idx_b)
            pair_ok = np.asarray(m.valid) & cand.has_depth[idx_b]
            if pair_ok.sum() < cfg.loop.min_matches:
                continue
            # 2D-3D: candidate's 3D points observed in the lost frame
            # (reference's loop path uses cv::solvePnPRansac the same way)
            X_b = jnp.asarray(cand.X_cam[idx_b], jnp.float32)
            uv_a = feats.uv
            self._key, sub = jax.random.split(self._key)
            r = sim3.ransac_pnp(X_b, uv_a, jnp.asarray(pair_ok),
                                jnp.asarray(self.intr), sub,
                                n_hyps=cfg.loop.ransac_hypotheses,
                                threshold=cfg.loop.ransac_threshold * 2)
            if int(r.n_inliers) < cfg.loop.min_inliers:
                continue
            rf = sim3.refine_pnp(r.S_ab, X_b, uv_a, r.inliers,
                                 jnp.asarray(pair_ok),
                                 jnp.asarray(self.intr),
                                 iters=cfg.loop.sim3_iterations)
            if int(rf.n_inliers) < cfg.loop.min_inliers:
                continue
            S_cur_cand = np.asarray(lie.sim3_to_se3(rf.S_ab), np.float64)
            T_cw = S_cur_cand @ system.kfs[cand_id].T_cw
            return dict(kf_id=cand_id, T_cw=T_cw,
                        n_inliers=int(rf.n_inliers))
        return None

    def run_pose_graph(self, system) -> None:
        """reference: Map::OptimizeALLKFs — window KFs + first KF fixed;
        optimized Sim3 poses written back to the (out-of-window) KF
        registry only. Snapshot under the system state lock; optimize
        lock-free; write back under the lock, skipping any KF that
        (re-)entered the window meanwhile."""
        cfg = self.cfg
        with system.state_lock:
            kf_ids = sorted(system.kfs.keys())
            if len(kf_ids) < 3:
                return
            kf_index = {k: i for i, k in enumerate(kf_ids)}
            K = len(kf_ids)
            S = np.stack([np.asarray(system.kfs[k].T_cw, np.float64)
                          for k in kf_ids])
            fixed = np.zeros(K, bool)
            fixed[0] = True
            for k in kf_ids:
                if system.kfs[k].in_window:
                    fixed[kf_index[k]] = True
            edges = list(system.pose_edges)

        # static edge capacity: next power of two over the edge count
        n_e = len(edges)
        cap = 1 << max(4, (n_e - 1).bit_length())
        ei, ej, S_meas, w = posegraph.build_edges(edges, kf_index, cap)
        out = posegraph.optimize_pose_graph(
            jnp.asarray(S), jnp.asarray(ei), jnp.asarray(ej),
            jnp.asarray(S_meas), jnp.asarray(w), jnp.asarray(fixed),
            lm_iters=cfg.loop.pgo_iterations)
        S_opt = np.asarray(out.S)
        with system.state_lock:
            for k in kf_ids:
                i = kf_index[k]
                if not fixed[i] and not system.kfs[k].in_window:
                    # keep the full Sim3 (scale-aware map consumers) and
                    # its center-preserving SE3 projection for trajectory
                    system.kfs[k].S_cw_opti = S_opt[i].copy()
                    system.kfs[k].T_cw = np.asarray(
                        lie.sim3_to_se3(jnp.asarray(S_opt[i])), np.float64)


class AsyncLoopClosing(LoopClosing):
    """Background loop-closure worker (reference: the LoopClosing thread
    spawned in FullSystem's ctor, src/frontend/LoopClosing.cc:~L40, plus
    Map::OptimizeALLKFs' detached PGO thread): keyframes are snapshotted
    at the mapping boundary and processed — ORB, BoW, matching, Sim3
    RANSAC/refine, pose-graph — off the tracking/mapping path. Device
    programs dispatched here interleave with the tracker's on the
    accelerator stream; all host work overlaps.

    Write-backs (pose edges, optimized out-of-window KF poses) go through
    ``system.state_lock`` exactly like the synchronous variant.
    """

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        import collections
        import threading
        self._queue = collections.deque()
        self._cv = threading.Condition()
        self._busy = False
        self._running = True
        self._exc = None
        self.results: List[dict] = []
        self._thread = threading.Thread(target=self._worker,
                                        name="ldso-loop", daemon=True)
        self._thread.start()

    def on_keyframe(self, system, kf, pyr):
        """Snapshot (win pytree ref + slot) now; process on the worker."""
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc
        with self._cv:
            self._queue.append((system, kf, pyr[0], system.win, kf.slot,
                                system.bank))
            self._cv.notify_all()
        return None

    def _worker(self):
        while True:
            with self._cv:
                while not self._queue and self._running:
                    self._cv.wait()
                if not self._queue and not self._running:
                    return
                item = self._queue.popleft()
                self._busy = True
            try:
                r = self._process(*item)
                if r is not None:
                    self.results.append(r)
            except BaseException as e:
                self._exc = e
            finally:
                with self._cv:
                    self._busy = False
                    self._cv.notify_all()

    def finish(self):
        """Drain the loop-closure queue (for sequence end / tests)."""
        with self._cv:
            while self._queue or self._busy:
                self._cv.wait()
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    def shutdown(self):
        self.finish()
        with self._cv:
            self._running = False
            self._cv.notify_all()
        self._thread.join(timeout=30.0)
