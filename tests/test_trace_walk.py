"""Device traceback walk (ops/trace_walk.py) + Aligner.align_cigars.

Bit-exactness contract: the device walk must reproduce golden
walk_trace / per-pair get_cigar strings for every mode, semi-global
free-end combination, and penalty regime (including gap_open <
gap_extend) — the same strings the reference's
parasail_result_get_cigar emits (src/alignment/mod.rs:390-419).
"""

import numpy as np
import pytest

from parasail_rs_tpu.engine import Aligner
from parasail_rs_tpu.matrices import Matrix
from parasail_rs_tpu.ops.trace_walk import device_walk, ops_to_runs
from parasail_rs_tpu.constants import cigar_runs_string

rng = np.random.default_rng(7)
DNA = list(b"ACGT")
AA = list(b"ARNDCQEGHILKMFPSTWYV")


def _seqs(alpha, n, lo, hi):
    return [rng.choice(alpha, size=rng.integers(lo, hi))
            .astype("uint8").tobytes() for _ in range(n)]


def _trace_aligner(builder):
    return builder.use_trace().build()


def _check(builder_fn, qs, rs):
    """align_cigars == per-pair get_cigar (golden walk) + same scalars."""
    tr = _trace_aligner(builder_fn())
    ref_alns = tr.align_batch(qs, rs)
    want = [a.get_cigar(q, r) for a, q, r in zip(ref_alns, qs, rs)]

    fast = builder_fn().build()
    alns, cigs = fast.align_cigars(qs, rs)
    assert cigs == want
    for a, b in zip(alns, ref_alns):
        assert a.get_score() == b.get_score()
        assert a.get_end_query() == b.get_end_query()
        assert a.get_end_ref() == b.get_end_ref()
        assert not a.is_trace()


def test_align_cigars_nw_dna():
    qs = _seqs(DNA, 16, 5, 40)
    rs = _seqs(DNA, 16, 5, 40)
    _check(lambda: Aligner.new().gap_open(5).gap_extend(2), qs, rs)


def test_align_cigars_sw_blosum():
    m = Matrix.from_name("blosum62")
    qs = _seqs(AA, 16, 10, 60)
    rs = _seqs(AA, 16, 10, 60)
    _check(lambda: Aligner.new().matrix(m).gap_open(11).gap_extend(1)
           .local(), qs, rs)


def test_align_cigars_sw_zero_score():
    # mismatch-only local pairs: empty alignment, empty CIGAR
    _check(lambda: Aligner.new().gap_open(5).gap_extend(2).local(),
           [b"AAAA"], [b"CCCC"])


@pytest.mark.parametrize("qgaps,dgaps", [
    ([], []),
    (["prefix"], []),
    ([], ["suffix"]),
    (["prefix", "suffix"], ["prefix", "suffix"]),
    (["suffix"], ["prefix"]),
])
def test_align_cigars_sg_free_variants(qgaps, dgaps):
    qs = _seqs(DNA, 8, 4, 30)
    rs = _seqs(DNA, 8, 4, 30)
    _check(lambda: Aligner.new().semi_global()
           .allow_query_gaps(qgaps).allow_ref_gaps(dgaps)
           .gap_open(4).gap_extend(1), qs, rs)


def test_align_cigars_open_below_extend():
    # gap_open < gap_extend: golden's gap-restart tie rules
    qs = _seqs(DNA, 8, 6, 30)
    rs = _seqs(DNA, 8, 6, 30)
    _check(lambda: Aligner.new().gap_open(1).gap_extend(5), qs, rs)
    _check(lambda: Aligner.new().gap_open(2).gap_extend(3).local(), qs, rs)


def test_align_cigars_profile_shared_query():
    from parasail_rs_tpu.engine import Profile

    m = Matrix.from_name("blosum62")
    q = _seqs(AA, 1, 20, 30)[0]
    rs = _seqs(AA, 6, 15, 40)
    prof = Profile.new(q, False, m)
    tr = (Aligner.new().profile(prof).gap_open(11).gap_extend(1).local()
          .use_trace().build())
    ref_alns = tr.align_batch(None, rs)
    want = [a.get_cigar(q, r) for a, r in zip(ref_alns, rs)]
    fast = (Aligner.new().profile(prof).gap_open(11).gap_extend(1)
            .local().build())
    _, cigs = fast.align_cigars(None, rs)
    assert cigs == want


def test_align_cigars_empty_batch():
    a = Aligner.new().build()
    assert a.align_cigars([], []) == ([], [])


def test_device_walk_matches_golden_walk_direct():
    """Walk a trace plane directly and compare runs with golden."""
    from parasail_rs_tpu.golden.model import walk_trace

    qs = _seqs(DNA, 5, 4, 25)
    rs = _seqs(DNA, 5, 4, 25)
    tr = Aligner.new().gap_open(3).gap_extend(1).local().use_trace().build()
    alns = tr.align_batch(qs, rs)
    Qp = max(len(q) for q in qs)
    Rp = max(len(r) for r in rs)
    B = len(qs)
    plane = np.zeros((B, Qp, Rp), np.int8)
    qidx = np.full((B, Qp), -1, np.int32)
    ridx = np.zeros((B, Rp), np.int32)
    enc = {c: i for i, c in enumerate(b"ACGT")}
    for b, (a, q, r) in enumerate(zip(alns, qs, rs)):
        t = a.fields["trace_table"]
        plane[b, :t.shape[0], :t.shape[1]] = t
        qidx[b, :len(q)] = [enc[c] for c in q]
        ridx[b, :len(r)] = [enc[c] for c in r]
    eq = np.array([a.get_end_query() for a in alns], np.int32)
    er = np.array([a.get_end_ref() for a in alns], np.int32)
    ops, bq, br = device_walk(plane, qidx, ridx, eq, er, "sw",
                              (True,) * 4)
    ops, bq, br = np.asarray(ops), np.asarray(bq), np.asarray(br)
    for b, (a, q, r) in enumerate(zip(alns, qs, rs)):
        w = walk_trace(a.fields["trace_table"], q, r,
                       int(eq[b]), int(er[b]), "sw")
        got = cigar_runs_string(ops_to_runs(ops[b]))
        want = "".join(f"{n}{op}" for n, op in w.ops)
        assert got == want
        assert int(bq[b]) == w.beg_query
        assert int(br[b]) == w.beg_ref


def test_ops_to_runs_merge_m():
    # backward ops: last column first => forward "==XI" -> runs
    row = np.array([3, 2, 1, 1], np.uint8)  # backward: I X = =
    assert cigar_runs_string(ops_to_runs(row)) == "2=1X1I"
    assert cigar_runs_string(ops_to_runs(row, merge_m=True)) == "3M1I"
    assert ops_to_runs(np.zeros(8, np.uint8)).size == 0


# ---------------------------------------------------------------------------
# Stats at gap_open <= gap_extend through the public device route
# ---------------------------------------------------------------------------
from parasail_rs_tpu.golden import align_seqs


def _golden_stats(q, r, m, open_, ext, mode, free=None):
    g = align_seqs(q, r, m, open_, ext, mode, free)
    return (g.score, g.end_query, g.end_ref, g.matches, g.similar, g.length)


@pytest.mark.parametrize("open_,ext", [(1, 3), (2, 5), (0, 1), (0, 0),
                                       (2, 2)])
@pytest.mark.parametrize("mode", ["nw", "sw", "sg"])
def test_stats_open_le_ext_device_route(open_, ext, mode):
    """The open <= ext stats regime matches golden exactly on the
    device route (golden's gap-restart tie rules included)."""
    qs = _seqs(DNA, 6, 4, 28)
    rs = _seqs(DNA, 6, 4, 28)
    b = Aligner.new().gap_open(open_).gap_extend(ext).use_stats()
    b = {"nw": b.global_, "sw": b.local, "sg": b.semi_global}[mode]()
    al = b.build()
    m = al.matrix
    res = al.align_batch(qs, rs)
    for a, q, r in zip(res, qs, rs):
        score, eq, er, mm, ss, ll = _golden_stats(q, r, m, open_, ext, mode)
        assert a.get_score() == score
        assert a.get_end_query() == eq and a.get_end_ref() == er
        assert a.get_matches() == mm
        assert a.get_similar() == ss
        assert a.get_length() == ll


def test_stats_open_le_ext_sg_free_variants():
    qs = _seqs(DNA, 4, 4, 20)
    rs = _seqs(DNA, 4, 4, 20)
    for qg, dg in [(["prefix"], []), ([], ["suffix"]),
                   (["suffix"], ["prefix"])]:
        al = (Aligner.new().semi_global().allow_query_gaps(qg)
              .allow_ref_gaps(dg).gap_open(1).gap_extend(4)
              .use_stats().build())
        res = al.align_batch(qs, rs)
        from parasail_rs_tpu.golden.model import free_flags

        free = free_flags("sg", qg, dg)
        for a, q, r in zip(res, qs, rs):
            score, eq, er, mm, ss, ll = _golden_stats(
                q, r, al.matrix, 1, 4, "sg", free)
            assert (a.get_score(), a.get_matches(), a.get_similar(),
                    a.get_length()) == (score, mm, ss, ll)


def test_stats_open_le_ext_blosum_profile():
    """Shared-query profile batches at open < ext."""
    from parasail_rs_tpu.engine import Profile

    m = Matrix.from_name("blosum62")
    q = _seqs(AA, 1, 15, 25)[0]
    rs = _seqs(AA, 5, 10, 30)
    prof = Profile.new(q, True, m)
    al = (Aligner.new().profile(prof).gap_open(1).gap_extend(2).local()
          .build())
    res = al.align_batch(None, rs)
    for a, r in zip(res, rs):
        score, eq, er, mm, ss, ll = _golden_stats(q, r, m, 1, 2, "sw")
        assert (a.get_score(), a.get_matches(), a.get_similar(),
                a.get_length()) == (score, mm, ss, ll)


def test_align_cigars_mixed_case_matches_get_cigar():
    """'=' vs 'X' follows golden's RAW byte comparison: lowercase query
    letters mismatch uppercase reference letters in the CIGAR even when
    the case-folding matrix maps them to the same index (regression:
    the device walk used mapped indices and emitted 4= here)."""
    q, r = b"acgt", b"ACGT"
    tr = Aligner.new().gap_open(5).gap_extend(2).use_trace().build()
    want = tr.align(q, r).get_cigar(q, r)
    assert want == "4X"
    fast = Aligner.new().gap_open(5).gap_extend(2).build()
    _, cigs = fast.align_cigars([q], [r])
    assert cigs == [want]
    # stats keep the mapped-index semantics: these ARE matches
    st = (Aligner.new().gap_open(1).gap_extend(2).use_stats().build())
    assert st.align(q, r).get_matches() == 4


def test_stats_walk_per_pair_profile_batch():
    """Per-pair (B, Qp, A) profile batches (build_batch) run stats at
    open < ext exactly, on the wavefront and on the kernel route."""
    from parasail_rs_tpu.engine.dispatch import (
        _execute_kernel, build_batch, execute)
    from parasail_rs_tpu.engine.profile import profile_rows
    from parasail_rs_tpu.golden import model as golden

    m = Matrix.from_name("blosum62")
    qs = _seqs(AA, 3, 5, 14)
    rs = _seqs(AA, 3, 5, 14)
    prows = [profile_rows(m, m.encode(q)) for q in qs]
    batch = build_batch(prows, [m.encode(q) for q in qs],
                        [m.encode(r) for r in rs])
    kw = dict(gap_open=1, gap_extend=3, mode="sw", free=(True,) * 4,
              outputs="stats", width="sat")
    for out in (execute(batch, **kw),
                _execute_kernel(batch, interpret=True, **kw)):
        for b in range(3):
            g = golden.align_seqs(qs[b], rs[b], m, 1, 3, "sw")
            assert int(out["matches"][b]) == g.matches
            assert int(out["similar"][b]) == g.similar
            assert int(out["length"][b]) == g.length


def test_align_cigars_result_contract():
    """align_cigars returns score-class Alignments: is_trace() False, no
    plane retained, CIGARs identical to the trace-plane walk."""
    qs = _seqs(DNA, 3, 6, 12)
    rs = _seqs(DNA, 3, 6, 12)
    fast = Aligner.new().gap_open(5).gap_extend(2).local().build()
    alns, cigs = fast.align_cigars(qs, rs)
    tr = Aligner.new().gap_open(5).gap_extend(2).local().use_trace().build()
    want = [a.get_cigar(q, r)
            for a, q, r in zip(tr.align_batch(qs, rs), qs, rs)]
    assert cigs == want
    for a in alns:
        assert not a.is_trace()
        with pytest.raises(Exception):
            a.get_trace_table()


def test_align_cigars_mixed_lengths_binned():
    """Mixed-length align_cigars length-bins internally (cell-sized
    planes) and returns input-order results identical to per-pair
    get_cigar."""
    qs = _seqs(DNA, 4, 4, 10) + _seqs(DNA, 4, 200, 400) + _seqs(DNA, 4, 30, 60)
    rs = _seqs(DNA, 4, 4, 10) + _seqs(DNA, 4, 200, 400) + _seqs(DNA, 4, 30, 60)
    tr = Aligner.new().gap_open(4).gap_extend(1).local().use_trace().build()
    want = [a.get_cigar(q, r)
            for a, q, r in zip(tr.align_batch(qs, rs), qs, rs)]
    fast = Aligner.new().gap_open(4).gap_extend(1).local().build()
    alns, cigs = fast.align_cigars(qs, rs)
    assert cigs == want
    assert [a.get_score() for a in alns] == \
        [a.get_score() for a in tr.align_batch(qs, rs)]


def test_align_many_stats_open_le_ext_binned():
    """align_many composes bins for stats at open <= ext: fetch_all
    handles the forms, results return in input order, golden-exact."""
    qs = _seqs(DNA, 6, 4, 20) + _seqs(DNA, 6, 100, 200)
    rs = _seqs(DNA, 6, 4, 20) + _seqs(DNA, 6, 100, 200)
    al = (Aligner.new().gap_open(1).gap_extend(3).local().use_stats()
          .build())
    res = al.align_many(qs, rs)
    for a, q, r in zip(res, qs, rs):
        g = align_seqs(q, r, al.matrix, 1, 3, "sw")
        assert (a.get_score(), a.get_matches(), a.get_similar(),
                a.get_length()) == (g.score, g.matches, g.similar,
                                    g.length)


def test_ops_to_runs_batch_matches_per_pair():
    """The vectorized batch RLE is output-identical to the per-pair
    ops_to_runs for every row shape: empty walks, full-length walks,
    single runs, and alternating ops — with and without M-merging."""
    from parasail_rs_tpu.ops.trace_walk import ops_to_runs, ops_to_runs_batch

    rng = np.random.default_rng(11)
    rows = []
    for n in (0, 1, 5, 37, 64):
        row = np.zeros(64, np.uint8)
        row[:n] = rng.integers(1, 5, n)
        rows.append(row)
    rows.append(np.full(64, 2, np.uint8))          # one long run
    rows.append(np.tile([1, 3], 32).astype(np.uint8))  # maximal run count
    ops = np.stack(rows)
    for merge_m in (False, True):
        got = ops_to_runs_batch(ops, merge_m=merge_m)
        want = [ops_to_runs(r, merge_m=merge_m) for r in ops]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_align_cigars_chunked_matches_unchunked():
    """The 512-pair sub-launch pipeline returns bit-identical results
    to a single launch covering the whole bin."""

    from parasail_rs_tpu.engine import Aligner
    from parasail_rs_tpu.engine.aligner import Aligner as Al
    from parasail_rs_tpu.matrices import Matrix

    rng = np.random.default_rng(17)
    aa = list(b"ARNDCQEGHILKMFPSTWYV")
    qs = [rng.choice(aa, size=rng.integers(20, 60)).astype("uint8")
          .tobytes() for _ in range(70)]
    rs = [rng.choice(aa, size=rng.integers(20, 60)).astype("uint8")
          .tobytes() for _ in range(70)]
    tr = (Aligner.new().matrix(Matrix.from_name("blosum62"))
          .gap_open(11).gap_extend(1).semi_global().build())
    old = Al._CIGAR_CHUNK
    try:
        Al._CIGAR_CHUNK = 1 << 30
        alns1, cigs1 = tr.align_cigars(qs, rs)
        Al._CIGAR_CHUNK = 32          # 70 pairs -> 3 chunks incl. tail
        alns2, cigs2 = tr.align_cigars(qs, rs)
    finally:
        Al._CIGAR_CHUNK = old
    assert cigs1 == cigs2
    assert [a.get_score() for a in alns1] == [a.get_score()
                                              for a in alns2]
    assert [a.get_end_ref() for a in alns1] == [a.get_end_ref()
                                                for a in alns2]
