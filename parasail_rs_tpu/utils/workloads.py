"""Seeded synthetic workloads for benchmarks and card smoke tests."""

from __future__ import annotations

import numpy as np

PROTEIN = b"ARNDCQEGHILKMFPSTWYV"
DNA = b"ACGT"


def homologous_pairs(rng, n, lo, hi, alphabet, sub_rate=0.15,
                     indel_rate=0.01, flank=0):
    """``n`` (query, reference) byte pairs.  Each query has a uniform
    length in [lo, hi]; its reference is drawn from it with
    substitutions at ``sub_rate`` and one-letter deletions and
    insertions at ``indel_rate`` each, then flanked by ``flank`` random
    letters split over both ends, so optimal alignments span the query."""
    alpha = np.frombuffer(alphabet, np.uint8)
    pairs = []
    for L in rng.integers(lo, hi + 1, n):
        q = alpha[rng.integers(0, len(alpha), L)]
        r = q.copy()
        sub = rng.random(L) < sub_rate
        r[sub] = alpha[rng.integers(0, len(alpha), int(sub.sum()))]
        u = rng.random(L)
        reps = np.where(u < indel_rate, 0, np.where(u > 1 - indel_rate, 2, 1))
        r = np.repeat(r, reps)
        ins = np.cumsum(reps)[reps == 2] - 1
        r[ins] = alpha[rng.integers(0, len(alpha), len(ins))]
        left = alpha[rng.integers(0, len(alpha), flank // 2)]
        right = alpha[rng.integers(0, len(alpha), flank - flank // 2)]
        pairs.append((q.tobytes(), np.concatenate([left, r, right]).tobytes()))
    return pairs
