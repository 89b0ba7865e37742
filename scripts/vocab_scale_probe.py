"""Vocabulary-scale measurement: does the 10^5-leaf top
rung of the online ladder suffice at KITTI-00 keyframe/descriptor
counts, or is the reference's 10^6-leaf DBoW3 tree needed?

Reference: n-lalanne/LDSO thirdparty/DBoW3 + vocab/orbvoc.dbow3 (k=10,
L=6 ~= 10^6 leaves, trained offline on millions of external ORB
descriptors). This engine trains its tree ONLINE from the map corpus
(loop/bow.py ladder, top rung k=10 L=5 = 10^5 leaves), so the right
question is measured, not assumed:

  1. retrieval quality at KITTI-00 scale (~1300 KFs x 500 desc) per
     rung: precision@1 and the true-match/best-false margin on revisit
     queries with descriptor noise + an aliased (repeated-texture)
     segment;
  2. cost per rung: train time, tree memory, per-KF encode latency,
     per-query database scan time (signatures are DENSE [n_leaves] --
     the L1 scan is one matvec, but memory scales with leaves x KFs);
  3. the 10^6 rung's PROJECTED costs from the same measurements.

Writes out/VOCAB_SCALE.json (out/ is git-ignored). CPU-runnable:
  JAX_PLATFORMS=cpu python scripts/vocab_scale_probe.py [n_kf]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("LDSO_NO_COMPILE_CACHE", "1")

import numpy as np

if os.environ.get("LDSO_PLATFORM", "cpu") == "cpu":
    import jax

    jax.config.update("jax_platforms", "cpu")

from ldso_tpu.loop import bow

N_DESC_PER_KF = 500          # reference: ~500-1000 ORB features per KF
ALIAS_SRC = range(60, 90)    # places whose texture repeats later
ALIAS_OFF = 400


def place_desc(place: int) -> np.ndarray:
    src = place - ALIAS_OFF if (place - ALIAS_OFF) in ALIAS_SRC else place
    rng = np.random.default_rng(5000 + src)
    return rng.integers(0, 256, (N_DESC_PER_KF, 32), dtype=np.uint8)


def visit_desc(place: int, seed: int) -> np.ndarray:
    """Observation = base descriptors with ~6 flipped bits (viewpoint)."""
    base = place_desc(place)
    rng = np.random.default_rng(seed)
    d = np.unpackbits(base, axis=1)
    for j in range(6):
        d[np.arange(N_DESC_PER_KF),
          rng.integers(0, 256, N_DESC_PER_KF)] ^= 1
    return np.packbits(d, axis=1)


def main(n_kf: int = 1300):
    import jax.numpy as jnp

    # out-and-back at KITTI-00 KF count: first half outbound (unique
    # places), second half revisits them in reverse
    half = n_kf // 2
    places = list(range(half)) + list(range(half - 1, -1, -1))
    print(f"corpus: {n_kf} KFs x {N_DESC_PER_KF} desc "
          f"= {n_kf * N_DESC_PER_KF} descriptors", flush=True)

    train_corpus = np.concatenate(
        [visit_desc(p, 3 * p) for p in range(0, half, 2)])

    rungs = [(10, 3), (10, 4), (10, 5)]
    results = []
    for k, L in rungs:
        t0 = time.time()
        vocab = bow.train_vocabulary(train_corpus, k=k, levels=L, seed=0,
                                     max_train=120_000)
        t_train = time.time() - t0
        n_leaves = vocab.n_leaves
        tree_mb = sum(t.size for t in vocab.tables) / 1e6  # u8 bytes

        # encode latency: median per-KF bow_vector time (50 KFs)
        valid = jnp.ones(N_DESC_PER_KF, bool)
        times = []
        vecs = {}
        db_ids = []
        for kf_id, p in enumerate(places):
            d = jnp.asarray(visit_desc(p, 10_000 + kf_id))
            t0 = time.perf_counter()
            v = np.asarray(bow.bow_vector(vocab, d, valid),
                           dtype=np.float32)
            if kf_id < 50:
                times.append(1e3 * (time.perf_counter() - t0))
            vecs[kf_id] = v
            db_ids.append(kf_id)
        enc_ms = float(np.median(times[2:]))

        # retrieval: queries = revisit KFs (2nd half); db = all older KFs
        # (chunked numpy L1 scan — the engine's query is the same matvec)
        n_q, hits, margins, scan_ms = 0, 0, [], []
        min_gap = 30
        q_ids = list(range(half + 5, n_kf, max((n_kf - half) // 60, 1)))
        sig = np.stack([vecs[i] for i in db_ids])
        for q in q_ids:
            true_place = places[q]
            t0 = time.perf_counter()
            cand = np.asarray(db_ids)[: q - min_gap]
            s = 1.0 - 0.5 * np.abs(sig[: q - min_gap]
                                   - vecs[q][None, :]).sum(axis=1)
            scan_ms.append(1e3 * (time.perf_counter() - t0))
            if len(s) == 0:
                continue
            n_q += 1
            best = cand[int(np.argmax(s))]
            is_true = abs(places[best] - true_place) <= 2
            hits += int(is_true)
            true_mask = np.asarray([abs(places[c] - true_place) <= 2
                                    for c in cand])
            if true_mask.any() and (~true_mask).any():
                margins.append(float(s[true_mask].max()
                                     - s[~true_mask].max()))
        row = dict(k=k, levels=L, n_leaves=int(n_leaves),
                   train_s=round(t_train, 1), tree_mb=round(tree_mb, 1),
                   encode_ms_per_kf=round(enc_ms, 2),
                   query_scan_ms=round(float(np.median(scan_ms)), 2),
                   signature_kb=round(4 * n_leaves / 1e3, 1),
                   db_mb_at_n_kf=round(4 * n_leaves * n_kf / 1e6, 1),
                   precision_at_1=round(hits / max(n_q, 1), 3),
                   true_vs_false_margin=round(float(np.median(margins)), 4)
                   if margins else None)
        results.append(row)
        print(json.dumps(row), flush=True)

    # projected 10^6 rung (k=10, L=6) from the measured curves
    r5 = results[-1]
    proj = dict(
        k=10, levels=6, n_leaves=10 ** 6,
        train_s_projected=round(r5["train_s"] * 10, 1),
        tree_mb=round(sum(32 * 10 ** (l + 1) for l in range(6)) / 1e6, 1),
        encode_ms_per_kf_projected=round(r5["encode_ms_per_kf"] * 6 / 5, 2),
        signature_kb=4000.0,
        db_mb_at_n_kf=round(4.0 * n_kf, 1),
        note="dense [n_leaves] signatures: at 10^6 leaves the database "
             "alone is ~5 GB at KITTI-00 KF counts — a 10^6 rung "
             "requires a sparse-signature redesign, and the measured "
             "precision curve shows what it would buy.")
    out = dict(
        corpus=dict(n_kf=n_kf, desc_per_kf=N_DESC_PER_KF,
                    aliased_places=[min(ALIAS_SRC), max(ALIAS_SRC)],
                    alias_offset=ALIAS_OFF),
        rungs=results, projected_1e6=proj,
        conclusion="filled in by the run summary below")
    hit4, hit5 = results[1]["precision_at_1"], results[2]["precision_at_1"]
    out["conclusion"] = (
        f"precision@1 at KITTI-00 corpus scale: 10^4 leaves {hit4:.3f}, "
        f"10^5 leaves {hit5:.3f} — the curve "
        + ("saturates below 10^5; the reference's 10^6 tree buys "
           "discrimination only for corpora far beyond single-sequence "
           "SLAM, while its dense-signature cost here would be ~5 GB. "
           "The 10^5 top rung is sufficient at reference KF counts."
           if hit5 - hit4 < 0.02 else
           "still improves at 10^5; a sparse-signature 10^6 rung is "
           "worth implementing."))
    out_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "out")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "VOCAB_SCALE.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(out["conclusion"])
    print("wrote", path)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 1300)
