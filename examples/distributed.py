"""Multi-device: data-parallel batches and a sequence-parallel long pair.

Run on every GPU of a host, or on 8 virtual CPU devices:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 python examples/distributed.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax

# The virtual-device CPU mesh is requested via XLA_FLAGS (see header);
# select the CPU platform before any backend initializes.
if "xla_force_host_platform_device_count" in os.environ.get("XLA_FLAGS", ""):
    jax.config.update("jax_platforms", "cpu")

from parasail_rs_tpu.dist import make_device_mesh, seqpar_align, sharded_align
from parasail_rs_tpu.dist.sharded import gather_scores
from parasail_rs_tpu.engine.dispatch import pack_pairs
from parasail_rs_tpu.engine.profile import profile_rows
from parasail_rs_tpu.matrices import Matrix

mesh = make_device_mesh()
m = Matrix.default()
rng = np.random.default_rng(1)
n = len(jax.devices())

# Data-parallel: a batch sharded over every device
refs = [rng.choice(list(b"ACGT"), size=64).astype("uint8").tobytes()
        for _ in range(8 * n)]
qs = [rng.choice(list(b"ACGT"), size=64).astype("uint8").tobytes()
      for _ in range(8 * n)]
batch, _, _ = pack_pairs(m, qs, refs)
from parasail_rs_tpu.engine.dispatch import _device_profile
out = sharded_align(
    mesh, np.asarray(_device_profile(batch.profile, batch.table, batch.qidx)),
    np.asarray(batch.qidx), np.asarray(batch.ridx), batch.qlen, batch.rlen,
    open_=5, ext=2, mode="sw", free=(True,) * 4, outputs="score")
print("data-parallel scores:", gather_scores(out)["score"][:8], "...")

# Sequence-parallel: ONE long pair, reference columns sharded over devices
L = 64 * n
q = rng.choice(list(b"ACGT"), size=L - 5).astype("uint8").tobytes()
r = rng.choice(list(b"ACGT"), size=L - 3).astype("uint8").tobytes()
prof = np.zeros((L, m.size, 1), np.int32)
prof[:len(q), :, 0] = profile_rows(m, m.encode(q))
ridx = np.zeros((L, 1), np.int32)
ridx[:len(r), 0] = m.encode(r)
sp = seqpar_align(prof, ridx, np.array([len(q)], np.int32),
                  np.array([len(r)], np.int32),
                  open_=5, ext=2, mesh=mesh, mode="sw", q_chunk=32)
print("sequence-parallel long-pair score:", int(sp["score"][0]))

# The same pair with trace output: each device emits its column shard of
# the flag plane; the host walk produces the CIGAR.
from parasail_rs_tpu.dist import seqpar_cigars

sp_tr = seqpar_align(prof, ridx, np.array([len(q)], np.int32),
                     np.array([len(r)], np.int32),
                     open_=5, ext=2, mesh=mesh, mode="sw", q_chunk=32,
                     outputs="trace")
cigar = seqpar_cigars(sp_tr, [q], [r], "sw", (True,) * 4)[0]
print("sequence-parallel CIGAR (first 60 chars):", cigar[:60])
