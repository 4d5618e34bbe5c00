"""Multi-host bootstrap tests.

`parallel.mesh.init_distributed` is the framework's DCN entry point
(PARITY #25) — the reference is single-node (README.md:28), so this
EXCEEDS parity, which is exactly why it needs its own evidence: nothing
else exercises it.  Two real things are tested here, both in
subprocesses (a process group cannot be built inside the pytest process —
it would wedge the shared backend):

* a REAL 2-process gloo group over the CPU backend runs a cross-process
  mode-2 psum SpMV and verifies it against the CPU oracle in both
  processes;
* a bad coordinator address fails LOUDLY (the r4 implementation swallowed
  RuntimeError/ValueError, silently degrading a multi-host misconfig to a
  single-host run).
"""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import sys
pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 4)
jax.config.update("jax_cpu_collectives_implementation", "gloo")
jax.config.update("jax_enable_x64", True)
from sblas.parallel import init_distributed, make_mesh
init_distributed(coordinator_address=f"localhost:{port}",
                 num_processes=nproc, process_id=pid)
assert jax.process_count() == nproc, jax.process_count()
init_distributed()  # idempotent re-entry must be a no-op, not a raise
import numpy as np, jax.numpy as jnp
from sblas.containers import DenseVector
from sblas.io.generate import uniform_random
from sblas.parallel.modes import spmv_dist
from sblas.partition import partition_nnz_balanced
from sblas.ops.cpu_reference import spmv_cpu
from sblas.utils.verify import check_equal
A = uniform_random(512, 512, 4, seed=3)
segs = partition_nnz_balanced(A, 8, dtype=jnp.float64)
x = DenseVector.random(512, dtype=np.float64)
y = DenseVector.constant(512, 1.0, dtype=np.float64)
mesh = make_mesh(8)  # 2 processes x 4 local devices
out = spmv_dist(segs, jnp.asarray(x.values), 3.0, 4.0,
                jnp.asarray(y.values), mesh)
got = np.asarray(jax.device_get(out))
rep = check_equal(got, spmv_cpu(A, x, 3.0, 4.0, y))
print(f"RESULT pid={pid} ok={rep.ok} sum={got.sum():.12e}", flush=True)
"""

_BAD_COORD = r"""
import jax
jax.config.update("jax_platforms", "cpu")
from sblas.parallel import init_distributed
try:
    init_distributed(coordinator_address="localhost:9",  # discard port
                     num_processes=2, process_id=1,
                     initialization_timeout=3)
except Exception as e:
    print(f"RAISED {type(e).__name__}", flush=True)
    raise SystemExit(7)
print("UNEXPECTED-CONTINUED", flush=True)
"""

_NO_ARGS = r"""
import jax
jax.config.update("jax_platforms", "cpu")
from sblas.parallel import init_distributed
try:
    init_distributed()  # no coordinator, not in a recognized cluster env
except Exception as e:
    print(f"RAISED {type(e).__name__}", flush=True)
    raise SystemExit(7)
print("UNEXPECTED-CONTINUED", flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(code: str, *args: str, timeout: int):
    env = {**os.environ, "PYTHONPATH": REPO}
    env.pop("JAX_PLATFORMS", None)  # workers force CPU via jax.config
    return subprocess.run([sys.executable, "-c", code, *args],
                          capture_output=True, text=True, timeout=timeout,
                          env=env, cwd=REPO)


@pytest.mark.slow
def test_two_process_mode2_spmv_verifies():
    port = str(_free_port())
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(pid), "2", port],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=REPO) for pid in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"worker rc={rc}\nstdout:{out}\nstderr:{err[-2000:]}"
        assert "ok=True" in out, out
    # both processes computed the SAME globally-reduced result
    sums = {line.split("sum=")[1] for rc, out, _ in outs
            for line in out.splitlines() if line.startswith("RESULT")}
    assert len(sums) == 1, sums


def test_bad_coordinator_fails_loudly():
    r = _spawn(_BAD_COORD, timeout=120)
    assert "UNEXPECTED-CONTINUED" not in r.stdout, (
        "misconfigured bootstrap silently degraded to single-host: "
        f"{r.stdout} {r.stderr[-500:]}")
    # two loud failure modes exist: a catchable Python exception (rc=7
    # from the probe) or the runtime's own fatal abort when the
    # coordination deadline expires (abseil F-log, nonzero rc) — both are
    # acceptable; rc=0 (the r4 swallow-and-continue) is not
    assert r.returncode != 0, (r.returncode, r.stdout, r.stderr[-500:])
    loud = (r.returncode == 7 and "RAISED" in r.stdout) or (
        "DEADLINE" in r.stderr or "coordination" in r.stderr.lower())
    assert loud, (r.returncode, r.stdout, r.stderr[-500:])


def test_missing_coordinator_fails_loudly():
    r = _spawn(_NO_ARGS, timeout=120)
    assert "UNEXPECTED-CONTINUED" not in r.stdout, (r.stdout,
                                                    r.stderr[-500:])
    assert r.returncode == 7 and "RAISED" in r.stdout, (r.returncode,
                                                        r.stdout,
                                                        r.stderr[-500:])
