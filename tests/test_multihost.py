"""Multi-host data parallelism, simulated with 2 CPU processes.

The reference has nothing distributed to test (SURVEY.md §4); the
strategy here is multi-process CPU simulation: two processes join a
jax.distributed group (4 virtual devices each -> an 8-device global
mesh), each feeds its half of a pair batch, and both must see the full,
golden-exact result set.
"""

import os
import socket
import subprocess
import sys

WORKER = r"""
import os, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")

coord, pid = sys.argv[1], int(sys.argv[2])
from parasail_rs_tpu.dist import multihost
multihost.initialize(coordinator_address=coord, num_processes=2, process_id=pid)
assert jax.process_count() == 2, jax.process_count()
mesh = multihost.global_mesh()

from parasail_rs_tpu.matrices import Matrix
from parasail_rs_tpu.engine.profile import profile_rows
from parasail_rs_tpu.engine.dispatch import build_batch
from parasail_rs_tpu.golden import model as golden

m = Matrix.from_name("blosum62")
rng = np.random.default_rng(7)   # same seed on both hosts -> same pairs
alpha = list(b"ARNDCQEGHILKMFPSTWYV")
B = 16
pairs, prows, qidxs, ridxs = [], [], [], []
for _ in range(B):
    q = rng.choice(alpha, size=rng.integers(4, 12)).astype("uint8").tobytes()
    r = rng.choice(alpha, size=rng.integers(4, 12)).astype("uint8").tobytes()
    pairs.append((q, r))
    qi, ri = m.encode(q), m.encode(r)
    qidxs.append(qi); ridxs.append(ri); prows.append(profile_rows(m, qi))
batch = build_batch(prows, qidxs, ridxs, Qp=16, Rp=16)

# each host contributes its half of the batch
half = B // 2
sl = slice(0, half) if pid == 0 else slice(half, B)
out = multihost.align_global(
    mesh,
    batch.profile[sl], batch.qidx[sl], batch.ridx[sl],
    batch.qlen[sl], batch.rlen[sl],
    open_=11, ext=1, mode="sw", free=(True,)*4, outputs="stats")

assert out["score"].shape[0] == B
for b in (0, 5, B - 1):
    g = golden.align_seqs(*pairs[b], m, 11, 1, "sw")
    assert out["score"][b] == g.score, (b, out["score"][b], g.score)
    assert out["matches"][b] == g.matches

# The GPU kernel route the single-device engine dispatches, sharded over
# the global mesh (through the Pallas interpreter here).
out_scan = multihost.align_global(
    mesh,
    batch.profile[sl], batch.qidx[sl], batch.ridx[sl],
    batch.qlen[sl], batch.rlen[sl],
    open_=11, ext=1, mode="sw", free=(True,)*4, outputs="stats",
    route="kernel", interpret=True)
for k in ("score", "matches", "similar", "length"):
    assert (out_scan[k] == out[k]).all(), (k, out_scan[k], out[k])
print(f"proc {pid} OK")
"""


def test_two_process_data_parallel(tmp_path):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    coord = f"localhost:{port}"
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env.pop("JAX_PLATFORMS", None)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), coord, str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            cwd=repo, text=True)
        for pid in (0, 1)
    ]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"proc {pid} OK" in out
