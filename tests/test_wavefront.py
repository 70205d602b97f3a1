"""Wavefront kernel (XLA path) vs golden oracle: randomized bit-exactness.

This is the kernel-level analog of the reference's integration suite: every
mode x free-end variant x output class is fuzzed against the scalar golden
model (SURVEY.md §4 strategy).
"""

import numpy as np
import pytest

from parasail_rs_tpu import Matrix
from parasail_rs_tpu.golden import align_seqs, free_flags
from parasail_rs_tpu.ops import wavefront_align
from parasail_rs_tpu.utils.shapes import pad_to

RNG = np.random.default_rng(42)
DNA = b"ACGT"
IDENT = Matrix.default()
B62 = Matrix.from_name("blosum62")
PROT = b"ARNDCQEGHILKMFPSTWYV"


def random_seq(alpha, lo, hi):
    n = int(RNG.integers(lo, hi + 1))
    return bytes(alpha[i] for i in RNG.integers(0, len(alpha), n))


def run_batch(pairs, matrix, open_, ext, mode, free, outputs, Qp=None, Rp=None, width="32"):
    """Pad a list of (query, ref) byte pairs and run the wavefront kernel."""
    B = len(pairs)
    Qp = Qp or max(len(q) for q, _ in pairs)
    Rp = Rp or max(len(r) for _, r in pairs)
    A = matrix.size
    prof = np.zeros((B, Qp, A), dtype=np.int32)
    qidx = np.zeros((B, Qp), dtype=np.int32)
    ridx = np.zeros((B, Rp), dtype=np.int32)
    qlen = np.zeros(B, dtype=np.int32)
    rlen = np.zeros(B, dtype=np.int32)
    for b, (q, r) in enumerate(pairs):
        qi, ri = matrix.encode(q), matrix.encode(r)
        qlen[b], rlen[b] = len(qi), len(ri)
        if matrix.kind == "square":
            prof[b, : len(qi)] = matrix.data[qi]
        else:
            prof[b, : len(qi)] = matrix.data[np.arange(len(qi)) % matrix.length]
        qidx[b, : len(qi)] = qi
        ridx[b, : len(ri)] = ri
    out = wavefront_align(
        prof, qidx, ridx, qlen, rlen,
        open_=open_, ext=ext, mode=mode, free=free, outputs=outputs, width=width,
    )
    return {k: np.asarray(v) for k, v in out.items()}


FREE_VARIANTS = [
    (False, False, False, False),
    (True, True, True, True),
    (True, False, False, False),
    (False, True, False, False),
    (False, False, True, False),
    (False, False, False, True),
    (True, True, False, False),
    (False, False, True, True),
    (True, False, False, True),
    (False, True, True, False),
]


@pytest.mark.parametrize("mode", ["nw", "sg", "sw"])
def test_score_matches_golden_fuzz(mode):
    pairs = [(random_seq(DNA, 1, 12), random_seq(DNA, 1, 14)) for _ in range(24)]
    for open_, ext in [(0, 0), (1, 1), (5, 2), (10, 1)]:
        free = free_flags(mode)
        out = run_batch(pairs, IDENT, open_, ext, mode, free, "score")
        for b, (q, r) in enumerate(pairs):
            g = align_seqs(q, r, IDENT, open_, ext, mode)
            assert out["score"][b] == g.score, (mode, open_, ext, q, r)
            assert out["end_query"][b] == g.end_query, (mode, q, r)
            assert out["end_ref"][b] == g.end_ref, (mode, q, r, out["end_ref"][b], g.end_ref)


@pytest.mark.parametrize("free", FREE_VARIANTS)
def test_sg_variants_match_golden(free):
    pairs = [(random_seq(DNA, 1, 10), random_seq(DNA, 1, 12)) for _ in range(16)]
    out = run_batch(pairs, IDENT, 2, 1, "sg", free, "score")
    for b, (q, r) in enumerate(pairs):
        g = align_seqs(q, r, IDENT, 2, 1, "sg", free=free)
        assert out["score"][b] == g.score, (free, q, r)
        assert out["end_query"][b] == g.end_query, (free, q, r)
        assert out["end_ref"][b] == g.end_ref, (free, q, r)


@pytest.mark.parametrize("mode", ["nw", "sg", "sw"])
def test_stats_match_golden(mode):
    pairs = [(random_seq(PROT, 1, 10), random_seq(PROT, 1, 11)) for _ in range(16)]
    out = run_batch(pairs, B62, 11, 1, mode, free_flags(mode), "stats")
    for b, (q, r) in enumerate(pairs):
        g = align_seqs(q, r, B62, 11, 1, mode)
        assert out["score"][b] == g.score, (mode, q, r)
        assert out["matches"][b] == g.matches, (mode, q, r)
        assert out["similar"][b] == g.similar, (mode, q, r)
        assert out["length"][b] == g.length, (mode, q, r)


@pytest.mark.parametrize("mode", ["nw", "sg", "sw"])
def test_tables_match_golden(mode):
    pairs = [(random_seq(DNA, 2, 8), random_seq(DNA, 2, 9)) for _ in range(8)]
    out = run_batch(pairs, IDENT, 2, 1, mode, free_flags(mode), "stats_table")
    for b, (q, r) in enumerate(pairs):
        g = align_seqs(q, r, IDENT, 2, 1, mode)
        ql, rl = len(q), len(r)
        assert np.array_equal(out["score_table"][b, :ql, :rl], g.score_table), (mode, q, r)
        assert np.array_equal(out["matches_table"][b, :ql, :rl], g.matches_table)
        assert np.array_equal(out["similar_table"][b, :ql, :rl], g.similar_table)
        assert np.array_equal(out["length_table"][b, :ql, :rl], g.length_table)


@pytest.mark.parametrize("mode", ["nw", "sg", "sw"])
def test_rowcol_matches_golden(mode):
    pairs = [(random_seq(DNA, 2, 8), random_seq(DNA, 2, 9)) for _ in range(8)]
    out = run_batch(pairs, IDENT, 2, 1, mode, free_flags(mode), "stats_rowcol")
    for b, (q, r) in enumerate(pairs):
        g = align_seqs(q, r, IDENT, 2, 1, mode)
        ql, rl = len(q), len(r)
        assert np.array_equal(out["score_row"][b, :rl], g.score_row), (mode, q, r)
        assert np.array_equal(out["score_col"][b, :ql], g.score_col), (mode, q, r)
        assert np.array_equal(out["matches_row"][b, :rl], g.matches_row)
        assert np.array_equal(out["length_col"][b, :ql], g.length_col)
        assert np.array_equal(out["similar_row"][b, :rl], g.similar_row)


@pytest.mark.parametrize("mode", ["nw", "sg", "sw"])
def test_trace_matches_golden(mode):
    pairs = [(random_seq(DNA, 2, 10), random_seq(DNA, 2, 10)) for _ in range(12)]
    out = run_batch(pairs, IDENT, 2, 1, mode, free_flags(mode), "trace")
    for b, (q, r) in enumerate(pairs):
        g = align_seqs(q, r, IDENT, 2, 1, mode)
        ql, rl = len(q), len(r)
        assert np.array_equal(out["trace_table"][b, :ql, :rl], g.trace_table), (
            mode, q, r, out["trace_table"][b, :ql, :rl], g.trace_table)


def test_padding_independence():
    """Results must not depend on the padded shape (static-shape bucketing)."""
    pairs = [(b"ACGTACGT", b"ACGTTACG")]
    a = run_batch(pairs, IDENT, 2, 1, "sw", free_flags("sw"), "score", Qp=8, Rp=8)
    b = run_batch(pairs, IDENT, 2, 1, "sw", free_flags("sw"), "score", Qp=32, Rp=48)
    assert a["score"][0] == b["score"][0]
    assert a["end_query"][0] == b["end_query"][0]
    assert a["end_ref"][0] == b["end_ref"][0]


def test_saturation_flags():
    # score exceeding +127 must flag 8-bit saturation, not 16-bit
    q = r = bytes(b"A" * 60)
    m = Matrix.create(b"ACGT", 3, -2)  # perfect match scores 180 > 127
    pairs = [(q, r)]
    out8 = run_batch(pairs, m, 1, 1, "nw", free_flags("nw"), "score", width="8")
    out16 = run_batch(pairs, m, 1, 1, "nw", free_flags("nw"), "score", width="16")
    assert bool(out8["saturated"][0])
    assert not bool(out16["saturated"][0])
    assert out16["score"][0] == 180


def test_pssm_profile_path():
    m = Matrix.create(b"ACGT", 2, -1).to_pssm(b"ACGT")
    out = run_batch([(b"ACGT", b"ACGT")], m, 0, 0, "nw", free_flags("nw"), "score")
    assert out["score"][0] == 8
