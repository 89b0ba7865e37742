"""Every matrix product in the device programs runs in true float32.

A float32 product with no precision pinned may run in TF32 on a GPU
(about three decimal digits), which is a fraction of a pixel in every
photometric residual. Each program below is traced to a jaxpr, and every
``dot_general`` in it, inside loops, conds and nested jits included,
must carry ``Precision.HIGHEST``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.extend import core as jcore

from ldso_tpu.config import preset

CFG = preset("tiny")
W, H = 128, 96
HIGHEST = jax.lax.Precision.HIGHEST


def _unpinned_dots(jaxpr, found=None):
    """(precision, source line) of every dot_general not at HIGHEST."""
    found = [] if found is None else found
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            p = eqn.params["precision"]
            ps = p if isinstance(p, tuple) else (p,)
            if not all(x == HIGHEST for x in ps):
                found.append((p, str(eqn.source_info.traceback)
                              .splitlines()[-1:]))
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                if isinstance(sub, jcore.ClosedJaxpr):
                    _unpinned_dots(sub.jaxpr, found)
                elif isinstance(sub, jcore.Jaxpr):
                    _unpinned_dots(sub, found)
    return found


def _intr():
    return jnp.asarray([0.88 * W, 0.88 * W, W / 2 - 0.5, H / 2 - 0.5],
                       jnp.float32)


def _track_inputs():
    from ldso_tpu import tracker
    from ldso_tpu.core import bank as bank_mod
    from ldso_tpu.core import window as win_mod

    rng = np.random.default_rng(0)
    L = CFG.shapes.pyr_levels
    n = CFG.shapes.track_points
    ref = tracker.make_tracker_ref(
        jnp.asarray(rng.uniform([8, 8], [W - 8, H - 8], (n, 2)), jnp.float32),
        jnp.asarray(rng.uniform(0.2, 2.0, n), jnp.float32),
        jnp.asarray(rng.uniform(30, 220, n), jnp.float32),
        jnp.ones(n, bool), L)
    m = CFG.shapes.max_immature
    bank = bank_mod.empty_bank(m)._replace(
        valid=jnp.ones(m, bool), host_slot=jnp.zeros(m, jnp.int32),
        uv=jnp.asarray(rng.uniform([8, 8], [W - 8, H - 8], (m, 2)),
                       jnp.float32),
        color=jnp.asarray(rng.uniform(30, 220, (m, 8)), jnp.float32),
        idepth_min=jnp.full(m, 0.1, jnp.float32),
        idepth_max=jnp.full(m, 2.0, jnp.float32))
    win = win_mod.empty_window(CFG, H, W, np.asarray(_intr()))
    img = jnp.asarray(rng.random((H, W)) * 255.0, jnp.float32)
    return img, ref, bank, win


def _fused_step():
    from ldso_tpu import frame_step

    img, ref, bank, win = _track_inputs()
    eye = jnp.eye(4, dtype=jnp.float32)
    return (lambda *a: frame_step.fused_step(*a, CFG),
            (img, ref, eye, eye, jnp.zeros(2, jnp.float32), bank,
             win.T_eval, win.x, win.exposure, eye, _intr(),
             jnp.float32(1.0)))


def _fused_batch():
    from ldso_tpu import frame_step

    img, ref, bank, win = _track_inputs()
    eye = jnp.eye(4, dtype=jnp.float32)
    return (lambda *a: frame_step.fused_batch(*a, CFG),
            (jnp.stack([img, img]), jnp.ones(2, jnp.float32), ref, eye, eye,
             jnp.zeros(2, jnp.float32), bank, win.T_eval, win.x,
             win.exposure, eye, _intr()))


def _ba_gn_step():
    import __graft_entry__

    return __graft_entry__.entry()


def _ba_lm_loop():
    import __graft_entry__
    from ldso_tpu.ba import solve

    _, (win,) = __graft_entry__.entry()
    D = CFG.shapes.state_dim
    return (lambda w, HM, bM: solve._ba_loop_device(w, HM, bM, CFG, 0),
            (win, jnp.zeros((D, D), jnp.float32), jnp.zeros(D, jnp.float32)))


def _correspondences(n=64, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform([-1, -1, 2], [1, 1, 4], (n, 3)).astype(np.float32)
    intr = np.asarray(_intr())
    uv = np.stack([intr[0] * X[:, 0] / X[:, 2] + intr[2],
                   intr[1] * X[:, 1] / X[:, 2] + intr[3]], -1)
    return (jnp.asarray(X), jnp.asarray(uv, jnp.float32),
            jnp.ones(n, bool), _intr())


def _ransac_sim3():
    from ldso_tpu.loop import sim3

    X, uv, valid, intr = _correspondences()
    return (lambda *a: sim3.ransac_sim3(*a, n_hyps=32),
            (X, uv, X, uv, valid, intr, jax.random.PRNGKey(0)))


def _refine_sim3():
    from ldso_tpu.loop import sim3

    X, uv, valid, intr = _correspondences()
    return (sim3.refine_sim3,
            (jnp.eye(4, dtype=jnp.float32), X, uv, X, uv, valid, valid, intr))


def _ransac_pnp():
    from ldso_tpu.loop import sim3

    X, uv, valid, intr = _correspondences()
    return (lambda *a: sim3.ransac_pnp(*a, n_hyps=32),
            (X, uv, valid, intr, jax.random.PRNGKey(0)))


def _refine_pnp():
    from ldso_tpu.loop import sim3

    X, uv, valid, intr = _correspondences()
    return (sim3.refine_pnp,
            (jnp.eye(4, dtype=jnp.float32), X, uv, valid, valid, intr))


def _pose_graph_inputs():
    import __graft_entry__

    return __graft_entry__._ring_graph(K=16, E=24)


def _pose_graph():
    from ldso_tpu.loop import posegraph

    S, ei, ej, S_meas, w, fixed = _pose_graph_inputs()
    return (lambda *a: posegraph.optimize_pose_graph(*a, lm_iters=2,
                                                     cg_iters=3),
            tuple(jnp.asarray(a) for a in (S, ei, ej, S_meas, w, fixed)))


def _pgo_edge_sharded():
    from ldso_tpu.distributed import sharded_pgo

    S, ei, ej, S_meas, w, fixed = _pose_graph_inputs()
    mesh = sharded_pgo.make_mesh(2)
    run = sharded_pgo.make_distributed_pgo(mesh, lm_iters=2, cg_iters=3)
    return run, (jnp.asarray(S), *sharded_pgo.shard_edges(
        ei, ej, S_meas, w, mesh), jnp.asarray(fixed))


def _pgo_block():
    from ldso_tpu.distributed import sharded_pgo

    S, ei, ej, S_meas, w, fixed = _pose_graph_inputs()
    mesh = sharded_pgo.make_mesh(2)
    part = sharded_pgo.partition_pose_graph(len(S), ei, ej, S_meas, w, 2)
    run = sharded_pgo.make_block_pgo(mesh, part, lm_iters=2, cg_iters=3)
    return run, (jnp.asarray(S), jnp.asarray(fixed))


PROGRAMS = {
    "fused_step": _fused_step,
    "fused_batch": _fused_batch,
    "ba_gn_step": _ba_gn_step,
    "ba_lm_loop": _ba_lm_loop,
    "ransac_sim3": _ransac_sim3,
    "refine_sim3": _refine_sim3,
    "ransac_pnp": _ransac_pnp,
    "refine_pnp": _refine_pnp,
    "pose_graph": _pose_graph,
    "pgo_edge_sharded": _pgo_edge_sharded,
    "pgo_block": _pgo_block,
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_every_product_is_highest(name):
    fn, args = PROGRAMS[name]()
    jaxpr = jax.make_jaxpr(fn)(*args).jaxpr
    n_dots = str(jaxpr).count("dot_general")
    assert n_dots > 0, f"{name}: no dot_general traced"
    assert _unpinned_dots(jaxpr) == [], name


def test_scan_finds_an_unpinned_product():
    """The scan itself: a product without a precision is reported, also
    when it sits inside a nested jit and a scan body."""
    inner = jax.jit(lambda a, b: a @ b)

    def f(a, b):
        return jax.lax.scan(lambda c, _: (inner(c, b), None), a, None,
                            length=2)[0]

    x = jnp.ones((3, 3), jnp.float32)
    assert len(_unpinned_dots(jax.make_jaxpr(f)(x, x).jaxpr)) == 1
