"""The public Aligner against golden/model.py, whatever route serves it.

These are the semantic cases a device fill must honour — modes x free
ends, widths and saturation, stats under every penalty regime, trace
flags (through CIGARs), banded, mixed lengths and shared-query profiles —
checked through the entry points users call.  They do not depend on
which kernel serves a case: on a GPU most run the Pallas kernel, here
they run the XLA wavefront.
"""

import numpy as np
import pytest

from parasail_rs_tpu.engine import Aligner, Profile
from parasail_rs_tpu.golden import model as golden
from parasail_rs_tpu.matrices import Matrix

AA = list(b"ARNDCQEGHILKMFPSTWYV")
DNA = list(b"ACGT")
B62 = Matrix.from_name("blosum62")

FREE = [  # (allow_query_gaps, allow_ref_gaps)
    ([], []),
    (["prefix"], []),
    (["suffix"], []),
    ([], ["prefix"]),
    ([], ["suffix"]),
    (["prefix", "suffix"], []),
    ([], ["prefix", "suffix"]),
    (["prefix"], ["suffix"]),
    (["suffix"], ["prefix"]),
]


def _seqs(seed, alpha, n, lo, hi):
    rng = np.random.default_rng(seed)
    return [rng.choice(alpha, size=int(rng.integers(lo, hi + 1)))
            .astype("uint8").tobytes() for _ in range(n)]


def _builder(mode, m, open_, ext, qg=(), dg=()):
    b = Aligner.new().matrix(m).gap_open(open_).gap_extend(ext)
    if mode == "nw":
        return b.global_()
    if mode == "sw":
        return b.local()
    return b.semi_global().allow_query_gaps(list(qg)).allow_ref_gaps(
        list(dg))


def _check(res, qs, rs, m, open_, ext, mode, free, stats):
    for a, q, r in zip(res, qs, rs):
        g = golden.align_seqs(q, r, m, open_, ext, mode, free)
        got = [a.get_score(), a.get_end_query(), a.get_end_ref()]
        want = [g.score, g.end_query, g.end_ref]
        if stats:
            got += [a.get_matches(), a.get_similar(), a.get_length()]
            want += [g.matches, g.similar, g.length]
        assert got == want, (q, r)


@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("qg,dg", FREE)
def test_sg_free_ends(qg, dg, stats):
    qs = _seqs(len(qg) * 7 + len(dg), DNA, 6, 1, 24)
    rs = _seqs(len(qg) * 7 + len(dg) + 1, DNA, 6, 1, 24)
    m = Matrix.create(b"ACGT", 2, -3)
    b = _builder("sg", m, 5, 2, qg, dg)
    al = (b.use_stats() if stats else b).build()
    free = golden.free_flags("sg", qg, dg)
    _check(al.align_batch(qs, rs), qs, rs, m, 5, 2, "sg", free, stats)


@pytest.mark.parametrize("open_,ext", [(11, 1), (3, 3), (1, 4), (0, 0)])
@pytest.mark.parametrize("mode", ["nw", "sg", "sw"])
def test_stats_penalty_regimes(mode, open_, ext):
    """Stats follow golden's tie rules for every penalty pair."""
    qs = _seqs(open_ + 10 * ext, AA, 6, 2, 30)
    rs = _seqs(open_ + 10 * ext + 1, AA, 6, 2, 30)
    al = _builder(mode, B62, open_, ext).use_stats().build()
    _check(al.align_batch(qs, rs), qs, rs, B62, open_, ext, mode,
           al.key.free, True)


@pytest.mark.parametrize("width", ["sat", "8", "16", "32", "64"])
def test_widths_and_saturation(width):
    """Scores stay exact at every width; the flag marks pairs whose DP
    leaves the width's range (parasail's retry-ladder semantics)."""
    m = Matrix.create(b"ACGT", 60, -40)
    qs = _seqs(50, DNA, 8, 1, 30)
    rs = _seqs(51, DNA, 8, 1, 30)
    al = Aligner.new().matrix(m).gap_open(6).gap_extend(2).local() \
        .solution_width(width).build()
    res = al.align_batch(qs, rs)
    _check(res, qs, rs, m, 6, 2, "sw", None, False)
    lim = {"8": 127, "16": 32767, "sat": 32767}.get(width)
    for a, q, r in zip(res, qs, rs):
        best = int(golden.align_seqs(q, r, m, 6, 2, "sw").score_table.max(
            initial=0))
        assert a.is_saturated() == (lim is not None and best >= lim)


@pytest.mark.parametrize("mode", ["nw", "sg", "sw"])
@pytest.mark.parametrize("open_,ext", [(5, 2), (1, 3)])
def test_trace_cigars(mode, open_, ext):
    """Trace flags, read through CIGARs, equal golden's walk."""
    qs = _seqs(60 + open_, DNA, 6, 2, 26)
    rs = _seqs(61 + open_, DNA, 6, 2, 26)
    m = Matrix.create(b"ACGT", 2, -3)
    al = _builder(mode, m, open_, ext).use_trace().build()
    for a, q, r in zip(al.align_batch(qs, rs), qs, rs):
        g = golden.align_seqs(q, r, m, open_, ext, mode)
        w = golden.walk_trace(g.trace_table, q, r, g.end_query, g.end_ref,
                              mode, golden.free_flags(mode))
        assert a.get_cigar(q, r) == w.cigar_string()


@pytest.mark.parametrize("bw", [4, 7, 40])
def test_banded_nw(bw):
    # lengths differ by at most 4, so the corner is inside every band
    qs = _seqs(70 + bw, DNA, 4, 10, 14)
    rs = _seqs(71 + bw, DNA, 4, 10, 14)
    m = Matrix.create(b"ACGT", 2, -3)
    al = Aligner.new().matrix(m).gap_open(4).gap_extend(1).bandwidth(bw) \
        .build()
    for a, q, r in zip(al.banded_nw_batch(qs, rs), qs, rs):
        want = golden.banded_nw_fill(m.scores_for(m.encode(q), m.encode(r)),
                                     4, 1, bw)
        assert a.get_score() == want


@pytest.mark.parametrize("outputs", ["score", "stats"])
def test_mixed_lengths_align_many(outputs):
    """align_many bins mixed lengths (one beyond the kernel's query
    limit) and returns input order."""
    qs = _seqs(80, DNA, 5, 3, 20) + _seqs(81, DNA, 2, 260, 300) + \
        _seqs(82, DNA, 4, 60, 90)
    rs = _seqs(83, DNA, 5, 3, 20) + _seqs(84, DNA, 2, 200, 300) + \
        _seqs(85, DNA, 4, 60, 90)
    m = Matrix.create(b"ACGT", 2, -3)
    b = Aligner.new().matrix(m).gap_open(5).gap_extend(2).local()
    al = (b.use_stats() if outputs == "stats" else b).build()
    _check(al.align_many(qs, rs), qs, rs, m, 5, 2, "sw", None,
           outputs == "stats")


@pytest.mark.parametrize("mode", ["nw", "sg", "sw"])
def test_shared_query_profile(mode):
    q = _seqs(90, AA, 1, 25, 25)[0]
    rs = _seqs(91, AA, 8, 5, 40)
    prof = Profile.new(q, True, B62)
    b = Aligner.new().profile(prof).gap_open(10).gap_extend(1)
    b = {"nw": b.global_, "sg": b.semi_global, "sw": b.local}[mode]()
    al = b.build()
    _check(al.align_batch(None, rs), [q] * len(rs), rs, B62, 10, 1, mode,
           al.key.free, True)


@pytest.mark.parametrize("mode", ["sw", "sg"])
def test_large_score_matrix_exact(mode):
    """Entries beyond +/-2048 are exact on every route (no float32
    matmul may round them)."""
    m = Matrix.create(b"ACGT", 3000, -2500)
    qs = _seqs(95, DNA, 6, 4, 24)
    rs = _seqs(96, DNA, 6, 4, 24)
    al = _builder(mode, m, 4000, 700).use_stats().build()
    _check(al.align_batch(qs, rs), qs, rs, m, 4000, 700, mode, al.key.free,
           True)
