"""True multi-process jax.distributed coordinator test (round-2 gap #6:
`mesh.init_distributed` was only no-op-tested — no test ever exercised
the coordinator handshake or a cross-process collective).

Spawns TWO separate Python processes on this machine, each with 2
virtual CPU devices; process 0 hosts the coordinator. Both must
complete ``jax.distributed.initialize`` through
``ldso_tpu.distributed.mesh.init_distributed`` (env-var driven, exactly
as a pod launcher would), see a 4-device global (proc=2, local=2) mesh,
and agree on a cross-process allgather. This is the same code path a
multi-host run takes; only the transport differs (SURVEY.md §5.8).
"""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import os, sys
sys.path.insert(0, os.environ["LDSO_REPO"])
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from ldso_tpu.distributed import mesh as mesh_mod

assert mesh_mod.init_distributed(), "coordinator env not picked up"
assert jax.process_count() == 2, f"process_count {jax.process_count()}"
assert len(jax.devices()) == 4, f"global devices {len(jax.devices())}"

from jax.experimental import multihost_utils
got = np.asarray(multihost_utils.process_allgather(
    np.asarray([10 * (jax.process_index() + 1)])))
assert sorted(got.reshape(-1).tolist()) == [10, 20], got

m = mesh_mod.make_mesh_2d()
assert m.devices.shape == (2, 2), m.devices.shape
assert m.axis_names == (mesh_mod.PROC_AXIS, mesh_mod.LOCAL_AXIS)
# success sentinel: a FILE, not stdout — child stdout interleaves with
# the Gloo shutdown banner and substring asserts on it are flaky
with open(os.environ["LDSO_SENTINEL"], "w") as f:
    f.write(f"CHILD_OK {jax.process_index()}")
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_coordinator_and_allgather(tmp_path):
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)
        env.pop("JAX_PLATFORMS", None)
        env.update(
            LDSO_REPO=REPO,
            LDSO_NO_COMPILE_CACHE="1",
            LDSO_SENTINEL=str(tmp_path / f"ok_{pid}"),
            JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
            JAX_NUM_PROCESSES="2",
            JAX_PROCESS_ID=str(pid),
        )
        procs.append(subprocess.Popen(
            [sys.executable, "-c", CHILD], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multi-process run timed out")
        outs.append((p.returncode, out, err))
    for pid, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"process {pid} failed:\n{err[-2000:]}"
        sentinel = tmp_path / f"ok_{pid}"
        assert sentinel.exists(), \
            f"process {pid} exited 0 but wrote no sentinel:\n{out[-500:]}"
        assert sentinel.read_text() == f"CHILD_OK {pid}"
