"""Benchmark: local SW scores of 8,192 homologous protein pairs on one GPU.

The setting BASELINE.json configs 2-4 describe: affine-gap Smith-Waterman
with BLOSUM62 at 11/1 over ~150-residue pairs, through
``Aligner.align_batch`` with results on the host.  Run from the repo root
on a machine with an NVIDIA GPU:

    python bench.py [--pairs 8192] [--reps 20] [--seed 0]

It exits non-zero without a GPU.  Its one line of output is JSON: the
device as JAX reports it, the card's name and power limit, the route
that served the batch, the median and minimum end-to-end time, the
alignments per second and useful (unpadded) GCUPS at the median, and the
host stages of one further call.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=8192)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"bench: no GPU (JAX platform {devs[0].platform!r})",
              file=sys.stderr)
        return 2
    from chip_smoke import card_line
    from parasail_rs_tpu import Aligner, Matrix
    from parasail_rs_tpu.engine import dispatch
    from parasail_rs_tpu.utils import compile_cache, stages
    from parasail_rs_tpu.utils.shapes import length_bucket
    from parasail_rs_tpu.utils.workloads import PROTEIN, homologous_pairs

    compile_cache.enable(ROOT)
    pairs = homologous_pairs(np.random.default_rng(args.seed), args.pairs,
                             140, 160, PROTEIN)
    qs, rs = (list(x) for x in zip(*pairs))
    al = (Aligner.new().matrix(Matrix.from_name("blosum62")).gap_open(11)
          .gap_extend(1).local().build())
    route = dispatch.choose_route(
        "score", length_bucket(max(map(len, qs))),
        length_bucket(max(map(len, rs))))[0]
    for _ in range(2):                       # compile + warm caches
        al.align_batch(qs, rs)
    times = []
    for _ in range(args.reps):
        t = time.perf_counter()
        al.align_batch(qs, rs)               # results are on the host
        times.append(time.perf_counter() - t)
    with stages.measuring():
        al.align_batch(qs, rs)
        host_stages = stages.snapshot()
    med = float(np.median(times))
    cells = sum(len(q) * len(r) for q, r in pairs)
    print(json.dumps({
        "device": {"platform": devs[0].platform,
                   "kind": devs[0].device_kind, "count": len(devs)},
        "card": card_line(), "route": route, "pairs": args.pairs,
        "median_ms": med * 1e3, "min_ms": min(times) * 1e3,
        "aln_per_s": args.pairs / med, "gcups": cells / med / 1e9,
        "stages": host_stages}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
