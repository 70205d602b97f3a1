"""Engine-layer integration tests through the public API.

Mirrors the reference's single-tier test strategy — every test in
reference tests/test_parasail.rs has an analog here with the same
sequences and arithmetic expectations (SURVEY.md §4), plus batch-API
extras (error guards, saturation flags, batch API).
"""

import threading

import numpy as np
import pytest

from parasail_rs_tpu import Matrix, TraceFlags, errors
from parasail_rs_tpu.engine import Aligner, Profile
from parasail_rs_tpu.golden import model as golden


# -- construction (reference test_parasail.rs:47-62) ------------------------
def test_aligner_construction():
    Aligner.new().build()
    (Aligner.new()
        .matrix(Matrix.default())
        .gap_open(10)
        .gap_extend(1)
        .profile(Profile.default())
        .allow_query_gaps(["prefix", "suffix"])
        .striped()
        .use_stats()
        .build())


def test_profile_construction():
    # reference test_parasail.rs:36-45
    query = b"ATGGCACTATAA"
    Profile.new(query, False, Matrix.default())
    Profile.new(query, True, Matrix.default())
    with pytest.raises(errors.QueryIsEmpty):
        Profile.new(b"", False, Matrix.default())
    p = Profile.builder(query, Matrix.default()).use_stats().build()
    assert p.use_stats and p.query_len == len(query)


# -- basic modes (reference test_parasail.rs:64-122) ------------------------
@pytest.mark.parametrize("mode", ["global", "semi_global", "local"])
def test_perfect_match_modes(mode):
    query = reference = b"ACGT"
    builder = Aligner.new().striped()
    getattr(builder, {"global": "global_", "semi_global": "semi_global",
                      "local": "local"}[mode])()
    aligner = builder.build()
    result = aligner.align(query, reference)
    n = len(query)
    assert result.get_score() == n
    assert result.get_end_query() == n - 1
    assert result.get_end_ref() == n - 1
    assert result.is_global() == (mode == "global")
    assert result.is_semi_global() == (mode == "semi_global")
    assert result.is_local() == (mode == "local")
    assert result.is_striped()
    assert not result.is_scan() and not result.is_diag()


# -- stats (reference test_parasail.rs:124-173) ------------------------------
@pytest.mark.parametrize("mode_setter", ["global_", "semi_global", "local"])
def test_with_stats(mode_setter):
    query = reference = b"ACGT"
    builder = Aligner.new().use_stats().striped()
    getattr(builder, mode_setter)()
    result = builder.build().align(query, reference)
    assert result.get_matches() == len(query)
    assert result.get_length() == len(query)
    assert result.is_stats()


# -- explicit widths (reference test_parasail.rs:175-253) --------------------
@pytest.mark.parametrize("width", [8, 16, 32, 64])
def test_global_widths(width):
    query = b"ACTGACTGACTG"
    reference = b"ACTGTCTGACTG"
    result = (Aligner.new().striped().solution_width(width).build()
              .align(query, reference))
    n = len(query)
    assert result.get_score() == n - 1
    assert result.get_end_query() == n - 1
    assert result.get_end_ref() == n - 1
    assert result.is_global() and result.is_striped()
    assert not result.is_saturated()


# -- tables (reference test_parasail.rs:255-383) -----------------------------
def test_score_table():
    query = reference = b"ACGT"
    result = Aligner.new().use_table().striped().build().align(query, reference)
    assert result.is_table()
    assert not result.is_stats() and not result.is_stats_table()
    table = result.get_score_table()
    assert table.rows() == len(query)
    assert table.cols() == len(reference)
    assert table.last() == len(query)
    assert table.get(0, 0) is not None
    assert table.get(99, 0) is None

    # with stats
    result = (Aligner.new().use_stats().use_table().striped().build()
              .align(query, reference))
    assert result.is_stats() and result.is_stats_table() and result.is_table()
    assert result.get_score_table().rows() == len(query)

    # with profile, without stats
    custom_score = 3
    matrix = Matrix.create(b"ACGT", custom_score, -2)
    profile = Profile.new(query, False, matrix)
    result = (Aligner.new().profile(profile).use_table().striped().build()
              .align(None, reference))
    assert result.is_table()
    assert not result.is_stats() and not result.is_stats_table()
    assert result.get_score_table().last() == len(query) * custom_score

    # with profile, with stats
    profile = Profile.new(query, True, matrix)
    result = (Aligner.new().profile(profile).use_stats().use_table().striped()
              .build().align(None, reference))
    assert result.is_stats() and result.is_stats_table() and result.is_table()
    assert result.get_score_table().last() == len(query) * custom_score


def test_matches_table():
    query, reference = b"ACGT", b"ACGTT"
    result = (Aligner.new().use_table().use_stats().striped().build()
              .align(query, reference))
    assert result.is_table() and result.is_stats() and result.is_stats_table()
    table = result.get_matches_table()
    assert table.rows() == len(query)
    assert table.cols() == len(reference)
    assert table.last() == len(query)


def test_similar_table():
    query = reference = b"ACGT"
    result = (Aligner.new().use_table().use_stats().striped().build()
              .align(query, reference))
    table = result.get_similar_table()
    assert table.rows() == len(query) and table.cols() == len(reference)
    str(table)


def test_length_table():
    query, reference = b"ACGT", b"ACGTTT"
    result = (Aligner.new().use_table().use_stats().striped().build()
              .align(query, reference))
    table = result.get_length_table()
    assert table.rows() == len(query) and table.cols() == len(reference)


# -- rowcol (reference test_parasail.rs:385-543) -----------------------------
def _stats_rowcol_result(query, reference):
    return (Aligner.new().use_last_rowcol().use_stats().striped().build()
            .align(query, reference))


def test_rows():
    result = _stats_rowcol_result(b"ACGT", b"ACG")
    assert result.is_stats_rowcol() and result.is_stats()
    assert not result.is_stats_table()
    np.testing.assert_array_equal(result.get_score_row(), [1, 2, 3])
    np.testing.assert_array_equal(result.get_matches_row(), [1, 2, 3])
    np.testing.assert_array_equal(result.get_similar_row(), [1, 2, 3])
    np.testing.assert_array_equal(result.get_length_row(), [4, 4, 4])


def test_cols():
    result = _stats_rowcol_result(b"ACG", b"ACGT")
    assert result.is_stats_rowcol() and result.is_stats()
    assert not result.is_stats_table()
    np.testing.assert_array_equal(result.get_score_col(), [1, 2, 3])
    np.testing.assert_array_equal(result.get_matches_col(), [1, 2, 3])
    np.testing.assert_array_equal(result.get_similar_col(), [1, 2, 3])
    np.testing.assert_array_equal(result.get_length_col(), [4, 4, 4])


# -- trace (reference test_parasail.rs:545-616) ------------------------------
def test_trace_table():
    query = reference = b"ACGT"
    result = Aligner.new().use_trace().striped().build().align(query, reference)
    assert result.is_trace()
    table = result.get_trace_table()
    assert table.rows() == len(query)
    assert table.cols() == len(reference)
    assert table.as_slice().shape[0] == 16
    for row in range(table.rows()):
        for col in range(table.cols()):
            flags = table.get(row, col)
            assert flags is not None
            assert flags != 0 or flags == TraceFlags.ZERO
    str(table)


@pytest.mark.parametrize("mode_setter", ["global_", "semi_global", "local"])
def test_cigars_batch_matches_per_pair(mode_setter):
    """Aligner.cigars (one native batch walk) must produce the exact
    strings the per-pair get_cigar path yields, for every mode."""
    import numpy as np

    rng = np.random.default_rng(5)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    qs = [rng.choice(alpha, size=int(l)).tobytes()
          for l in rng.integers(5, 40, 32)]
    rs = [rng.choice(alpha, size=int(l)).tobytes()
          for l in rng.integers(5, 40, 32)]
    builder = Aligner.new().use_trace().gap_open(3).gap_extend(1)
    getattr(builder, mode_setter)()
    al = builder.build()
    res = al.align_batch(qs, rs)
    batch = al.cigars(res, qs, rs)
    per_pair = [a.get_cigar(q, r) for a, q, r in zip(res, qs, rs)]
    assert batch == per_pair


def test_cigars_requires_trace():
    from parasail_rs_tpu.errors import NoTrace

    al = Aligner.new().build()
    res = al.align_batch([b"ACGT"], [b"ACGT"])
    with pytest.raises(NoTrace):
        al.cigars(res, [b"ACGT"], [b"ACGT"])


def test_traceback_strings_and_cigar(capsys):
    query = reference = b"ACGT"
    result = Aligner.new().use_trace().striped().build().align(query, reference)
    tb = result.get_traceback_strings(query, reference)
    assert tb.query == "ACGT"
    assert tb.comparison == "||||"
    assert tb.reference == "ACGT"
    assert result.get_cigar(query, reference) == "4="
    result.print_traceback(query, reference)
    out = capsys.readouterr().out
    assert "Query:" in out and "Target:" in out and "Score: 4" in out


# -- profile alignment (reference test_parasail.rs:618-687) ------------------
@pytest.mark.parametrize("mode_setter", ["global_", "semi_global", "local"])
def test_with_profile(mode_setter):
    query = reference = b"ACGT"
    profile = Profile.new(query, True, Matrix.default())
    builder = Aligner.new().profile(profile).use_stats().striped()
    getattr(builder, mode_setter)()
    result = builder.build().align(None, reference)
    assert result.is_stats() and result.is_striped()
    assert result.get_score() == len(query)
    modes = {"global_": "is_global", "semi_global": "is_semi_global",
             "local": "is_local"}
    for setter, pred in modes.items():
        assert getattr(result, pred)() == (setter == mode_setter)


# -- multithreading (reference test_parasail.rs:689-723) ---------------------
def test_multithread_global_alignment():
    query = b"ACGT"
    refs = [b"ACGT", b"ACGT"]
    profile = Profile.new(query, True, Matrix.default())
    aligner = Aligner.new().profile(profile).use_stats().striped().build()
    scores = []

    def run(reference):
        scores.append(aligner.align(None, reference).get_score())

    threads = [threading.Thread(target=run, args=(r,)) for r in refs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert scores == [len(query)] * len(refs)


# -- banded NW (reference test_parasail.rs:725-736) --------------------------
def test_banded_nw():
    query = reference = b"ACGT"
    aligner = Aligner.new().bandwidth(2).build()
    result = aligner.banded_nw(query, reference)
    assert result.get_score() == len(query)
    assert result.is_banded() and result.is_global()
    assert not result.is_striped()


def test_banded_nw_matches_full_nw_when_band_covers():
    rng = np.random.default_rng(7)
    m = Matrix.create(b"ACGT", 2, -3)
    for _ in range(5):
        q = rng.choice(list(b"ACGT"), size=rng.integers(5, 20)).astype("uint8").tobytes()
        r = rng.choice(list(b"ACGT"), size=rng.integers(5, 20)).astype("uint8").tobytes()
        full = (Aligner.new().matrix(m).gap_open(5).gap_extend(1).build()
                .align(q, r).get_score())
        banded = (Aligner.new().matrix(m).gap_open(5).gap_extend(1)
                  .bandwidth(max(len(q), len(r))).build()
                  .banded_nw(q, r).get_score())
        assert banded == full


def test_banded_nw_requires_bandwidth():
    with pytest.raises(errors.NoBandwidth):
        Aligner.new().build().banded_nw(b"ACGT", b"ACGT")


# -- SSW (reference test_parasail.rs:738-765) --------------------------------
def test_ssw_alignment():
    query = reference = b"ACGT"
    result = Aligner.new().build().ssw(query, reference)
    n = len(query)
    assert result.score() == n
    assert result.query_end() == n - 1
    assert result.ref_end() == n - 1
    assert result.query_start() == 0
    assert result.ref_start() == 0
    assert result.cigar_len() >= 1
    assert result.cigar_string() == "4M"


def test_ssw_init():
    Profile.new_ssw(b"ACGT", Matrix.default(), 2)


def test_ssw_profile_score_size():
    """score_size semantics (reference src/profile/mod.rs:337-358 +
    src/alignment/mod.rs:507-544): 0 = 8-bit — saturated lanes report
    the SSW cap score1=255; 1/2 = 16-bit (exact up to 65535)."""
    m = Matrix.create(b"ACGT", 5, -4)
    q = b"ACGT" * 40                     # perfect match scores 800 > 255
    refs = [q, q[:20]]
    for size, want_big in ((0, 255), (1, 800), (2, 800)):
        prof = Profile.new_ssw(q, m, size)
        a = Aligner.new().profile(prof).gap_open(10).gap_extend(1).build()
        res = a.ssw_batch(None, refs)
        assert res[0].score() == want_big, (size, res[0].score())
        # sub-saturation pair is exact in every mode
        assert res[1].score() == 100, (size, res[1].score())


def test_ssw_profile_reuses_tensors_and_matches_query_path():
    m = Matrix.create(b"ACGT", 2, -3)
    q = b"ACGTTACGGT"
    refs = [b"ACGTACGT", b"TTTTACGTT", b"GGACGTTACG"]
    prof = Profile.new_ssw(q, m, 2)
    via_profile = (Aligner.new().profile(prof).gap_open(4).gap_extend(1)
                   .build().ssw_batch(None, refs))
    via_query = (Aligner.new().matrix(m).gap_open(4).gap_extend(1)
                 .build().ssw_batch([q] * len(refs), refs))
    for p, r in zip(via_profile, via_query):
        assert p.score() == r.score()
        assert (p.ref_start(), p.ref_end(), p.query_start(), p.query_end()) \
            == (r.ref_start(), r.ref_end(), r.query_start(), r.query_end())
        assert p.cigar_string() == r.cigar_string()


# -- batch-API extras --------------------------------------------------------
def test_error_guards():
    result = Aligner.new().build().align(b"ACGT", b"ACGT")
    with pytest.raises(errors.NoStats):
        result.get_matches()
    with pytest.raises(errors.NoStats):
        result.get_similar()
    with pytest.raises(errors.NoTable):
        result.get_score_table()
    with pytest.raises(errors.NoRowCol):
        result.get_score_row()
    with pytest.raises(errors.NoTrace):
        result.get_cigar(b"ACGT", b"ACGT")
    with pytest.raises(errors.QueryRequired):
        Aligner.new().build().align(None, b"ACGT")
    with pytest.raises(errors.UnknownKernel):
        # profile requires striped or scan (reference assert,
        # src/aligner/mod.rs:307-310)
        (Aligner.new().profile(Profile.new(b"ACGT", False, Matrix.default()))
         .diag().build())


def test_saturation_flag_8bit():
    # score 200 > 127 overflows an 8-bit lane
    m = Matrix.create(b"ACGT", 10, -1)
    q = r = b"ACGT" * 5  # 20 matches * 10 = 200
    result = (Aligner.new().matrix(m).solution_width(8).build().align(q, r))
    assert result.get_score() == 200  # exact despite the flag
    assert result.is_saturated()
    # sat ladder: 8-bit overflow but 16-bit fine -> not saturated
    result = (Aligner.new().matrix(m).solution_width("sat").build().align(q, r))
    assert result.get_score() == 200
    assert not result.is_saturated()


def test_align_batch_mixed_lengths():
    rng = np.random.default_rng(3)
    m = Matrix.from_name("blosum62")
    alpha = list(b"ARNDCQEGHILKMFPSTWYV")
    pairs = [
        (rng.choice(alpha, size=rng.integers(4, 40)).astype("uint8").tobytes(),
         rng.choice(alpha, size=rng.integers(4, 40)).astype("uint8").tobytes())
        for _ in range(9)
    ]
    aligner = (Aligner.new().matrix(m).gap_open(11).gap_extend(1).local()
               .use_stats().build())
    results = aligner.align_batch([q for q, _ in pairs], [r for _, r in pairs])
    for (q, r), res in zip(pairs, results):
        g = golden.align_seqs(q, r, m, 11, 1, "sw")
        assert res.get_score() == g.score
        assert res.get_end_query() == g.end_query
        assert res.get_end_ref() == g.end_ref
        assert res.get_matches() == g.matches
        assert res.get_similar() == g.similar
        assert res.get_length() == g.length


def test_semi_global_gap_variants_engine():
    # free-end grammar through the builder (reference: aligner/mod.rs:270-299)
    q, r = b"TTACGT", b"ACGTGG"
    for qgaps, rgaps in [([], []), (["prefix"], []), ([], ["suffix"]),
                         (["prefix", "suffix"], ["prefix"])]:
        res = (Aligner.new().semi_global().allow_query_gaps(qgaps)
               .allow_ref_gaps(rgaps).build().align(q, r))
        g = golden.align_seqs(q, r, Matrix.default(), 0, 0, "sg",
                              golden.free_flags("sg", qgaps, rgaps))
        assert res.get_score() == g.score, (qgaps, rgaps)


def test_banded_nw_batch_and_scalar_oracle():
    # the kernel banded path must match the scalar banded fill
    from parasail_rs_tpu.golden import banded_nw_fill

    rng = np.random.default_rng(21)
    m = Matrix.create(b"ACGT", 2, -3)
    for bw in (1, 3, 8):
        aligner = (Aligner.new().matrix(m).gap_open(4).gap_extend(1)
                   .bandwidth(bw).build())
        qs, rs = [], []
        for _ in range(6):
            qs.append(rng.choice(list(b"ACGT"),
                                 size=rng.integers(4, 30)).astype("uint8").tobytes())
            rs.append(rng.choice(list(b"ACGT"),
                                 size=rng.integers(4, 30)).astype("uint8").tobytes())
        batch = aligner.banded_nw_batch(qs, rs)
        for q, r, res in zip(qs, rs, batch):
            sub = m.scores_for(m.encode(q), m.encode(r)).astype(np.int64)
            want = banded_nw_fill(sub, 4, 1, bw)
            got = res.get_score()
            if want < -(10 ** 8):
                # corner outside the band: unreachable in both (the
                # sentinels differ; parasail would be similarly undefined)
                assert got < -(10 ** 8), (q, r, bw)
            else:
                assert got == want, (q, r, bw)
            assert res.is_banded()


def test_profile_mode_shares_query_tensors():
    # Profile reuse (one query vs many references) must ship the query
    # profile once, not once per pair, and stay correct.
    from parasail_rs_tpu.engine import dispatch as disp

    m = Matrix.from_name("blosum62")
    profile = Profile.new(b"HEAGAWGHEE", True, m)
    seen = {}
    orig = disp.pack_pairs

    def spy(*args, **kwargs):
        batch, qlens, rlens = orig(*args, **kwargs)
        seen["profile_shape"] = batch.profile.shape
        return batch, qlens, rlens

    disp_pack, disp.pack_pairs = disp.pack_pairs, spy
    try:
        aligner = (Aligner.new().profile(profile).use_stats()
                   .gap_open(11).gap_extend(1).local().build())
        refs = [b"PAWHEAE", b"AWGHEE", b"HEAGAWGHEE", b"GGGGG"]
        results = aligner.align_batch(None, refs)
    finally:
        disp.pack_pairs = disp_pack
    assert seen["profile_shape"][0] == 1  # shared, not per-pair
    for r, res in zip(refs, results):
        g = golden.align_seqs(b"HEAGAWGHEE", r, m, 11, 1, "sw")
        assert res.get_score() == g.score
        assert res.get_matches() == g.matches


def test_ssw_batch():
    rng = np.random.default_rng(31)
    m = Matrix.from_name("blosum62")
    aligner = Aligner.new().matrix(m).gap_open(11).gap_extend(1).build()
    alpha = list(b"ARNDCQEGHILKMFPSTWYV")
    qs = [rng.choice(alpha, size=rng.integers(5, 30)).astype("uint8").tobytes()
          for _ in range(12)]
    rs = [rng.choice(alpha, size=rng.integers(5, 30)).astype("uint8").tobytes()
          for _ in range(12)]
    batch = aligner.ssw_batch(qs, rs)
    for q, r, res in zip(qs, rs, batch):
        one = aligner.ssw(q, r)
        assert res.score() == one.score()
        assert res.cigar_string() == one.cigar_string()
        assert (res.query_start(), res.ref_start()) == \
            (one.query_start(), one.ref_start())
        g = golden.align_seqs(q, r, m, 11, 1, "sw")
        assert res.score() == min(g.score, 0xFFFF)


def test_streaming_aligner():
    from parasail_rs_tpu.engine.stream import StreamingAligner

    rng = np.random.default_rng(41)
    m = Matrix.create(b"ACGT", 2, -3)
    aligner = (Aligner.new().matrix(m).gap_open(4).gap_extend(1).local()
               .use_stats().build())
    pairs = []
    for _ in range(57):
        pairs.append((
            rng.choice(list(b"ACGT"),
                       size=rng.integers(3, 120)).astype("uint8").tobytes(),
            rng.choice(list(b"ACGT"),
                       size=rng.integers(3, 120)).astype("uint8").tobytes()))
    stream = StreamingAligner(aligner, flush_size=16)
    handles = [stream.submit(q, r) for q, r in pairs]
    stream.flush()
    for (q, r), h in zip(pairs, handles):
        assert h.done()
        res = h.result()
        one = aligner.align(q, r)
        assert res.get_score() == one.get_score(), (q, r)
        assert res.get_matches() == one.get_matches()

    # result() on a pending handle flushes implicitly
    stream2 = StreamingAligner(aligner, flush_size=1000)
    h = stream2.submit(b"ACGT", b"ACGT")
    assert not h.done()
    assert h.result().get_score() == aligner.align(b"ACGT", b"ACGT").get_score()


def test_streaming_submit_many():
    """Bulk submit matches the per-pair loop: same results, input order,
    flush thresholds respected (a group larger than flush_size splits
    into multiple launches)."""
    from parasail_rs_tpu.engine.stream import StreamingAligner

    rng = np.random.default_rng(43)
    m = Matrix.create(b"ACGT", 2, -3)
    aligner = (Aligner.new().matrix(m).gap_open(4).gap_extend(1).local()
               .use_stats().build())
    pairs = [
        (rng.choice(list(b"ACGT"),
                    size=rng.integers(3, 120)).astype("uint8").tobytes(),
         rng.choice(list(b"ACGT"),
                    size=rng.integers(3, 120)).astype("uint8").tobytes())
        for _ in range(73)]
    qs = [q for q, _ in pairs]
    rs = [r for _, r in pairs]
    expected = aligner.align_batch(qs, rs)
    with StreamingAligner(aligner, flush_size=16) as stream:
        handles = stream.submit_many(qs, rs)
        stream.flush()
        assert len(handles) == len(pairs)
        for exp, h in zip(expected, handles):
            res = h.result(timeout=60)
            assert res.get_score() == exp.get_score()
            assert res.get_matches() == exp.get_matches()
            assert res.get_end_ref() == exp.get_end_ref()

    # mixing bulk and per-pair submission into the same buckets
    with StreamingAligner(aligner, flush_size=16) as stream:
        h1 = stream.submit(qs[0], rs[0])
        hs = stream.submit_many(qs[1:5], rs[1:5])
        stream.flush()
        assert h1.result(timeout=60).get_score() == expected[0].get_score()
        for exp, h in zip(expected[1:5], hs):
            assert h.result(timeout=60).get_score() == exp.get_score()

    # profile-held queries: queries arg is ignored / may be None
    prof_aligner = (Aligner.new().matrix(m).gap_open(4).gap_extend(1)
                    .local().profile(Profile.new(qs[0], False, m)).build())
    with StreamingAligner(prof_aligner, flush_size=8) as stream:
        hs = stream.submit_many(None, rs[:6])
        stream.flush()
        for r, h in zip(rs[:6], hs):
            assert h.result(timeout=60).get_score() == \
                prof_aligner.align(None, r).get_score()


def test_streaming_per_bucket_resolution():
    """result() must resolve only its own bucket — other buckets keep
    accumulating (no global flush), and full buckets resolve in the
    background without any flush() call."""
    import time

    from parasail_rs_tpu.engine.stream import StreamingAligner

    m = Matrix.create(b"ACGT", 2, -3)
    aligner = (Aligner.new().matrix(m).gap_open(4).gap_extend(1).local()
               .build())
    with StreamingAligner(aligner, flush_size=4) as stream:
        # bucket A: short pairs (fills: 4 submissions -> auto-dispatch)
        ha = [stream.submit(b"ACGT", b"ACGTA") for _ in range(4)]
        # bucket B: long pairs (1 submission, stays partial)
        hb = stream.submit(b"ACGT" * 30, b"ACGTA" * 30)
        # the full bucket resolves in the background without flush()
        deadline = time.time() + 30
        while not all(h.done() for h in ha) and time.time() < deadline:
            time.sleep(0.01)
        assert all(h.done() for h in ha)
        assert not hb.done()
        # resolving B's handle dispatches ONLY bucket B
        assert hb.result(timeout=60).get_score() == \
            aligner.align(b"ACGT" * 30, b"ACGTA" * 30).get_score()
        for h in ha:
            assert h.result().get_score() == \
                aligner.align(b"ACGT", b"ACGTA").get_score()

    # interleaved submit/result across buckets
    with StreamingAligner(aligner, flush_size=8) as s:
        out = []
        for i in range(20):
            q = b"ACGT" * (1 + i % 3)
            r = b"ACGTA" * (1 + i % 5)
            h = s.submit(q, r)
            out.append((q, r, h))
            if i % 7 == 6:
                qq, rr, hh = out[i - 3]
                assert hh.result(timeout=60).get_score() == \
                    aligner.align(qq, rr).get_score()
        for q, r, h in out:
            assert h.result(timeout=60).get_score() == \
                aligner.align(q, r).get_score()


def test_ssw_windowed_matches_one_pass():
    """Three-pass windowed SSW (long-pair route) agrees with the
    one-pass full-trace walk: identical scores and end coordinates,
    begin coordinates that re-score to the same alignment, and a CIGAR
    whose re-scored value equals score1."""
    from parasail_rs_tpu.golden import align_seqs

    rng = np.random.default_rng(7)
    aa = b"ARNDCQEGHILKMFPSTWYV"
    m = Matrix.from_name("blosum62")
    qs, rs = [], []
    for _ in range(6):
        q = rng.choice(list(aa), size=int(rng.integers(30, 70))).astype(
            "uint8").tobytes()
        r = bytearray(rng.choice(list(aa), size=int(
            rng.integers(80, 160))).astype("uint8").tobytes())
        # plant a homologous region so local alignments are nontrivial
        at = int(rng.integers(0, len(r) - len(q) // 2))
        r[at:at + len(q) // 2] = q[: len(q) // 2]
        qs.append(q)
        rs.append(bytes(r))
    al = Aligner.new().matrix(m).gap_open(11).gap_extend(1).build()
    one = al.ssw_batch(qs, rs, windowed=False)
    win = al.ssw_batch(qs, rs, windowed=True)
    for q, r, o, w in zip(qs, rs, one, win):
        assert w.score1 == o.score1
        assert w.read_end1 == o.read_end1
        assert w.ref_end1 == o.ref_end1
        # begins: the window must re-score to the full local score
        g = align_seqs(q[w.read_begin1:w.read_end1 + 1],
                       r[w.ref_begin1:w.ref_end1 + 1],
                       m, 11, 1, mode="nw")
        assert g.score == o.score1, (g.score, o.score1)
        # CIGAR re-scores to score1
        assert _rescore_cigar(
            w.cigar_string(), q[w.read_begin1:], r[w.ref_begin1:],
            m, 11, 1) == o.score1


def _rescore_cigar(cig, q, r, m, open_, ext):
    import re

    qi = ri = 0
    score = 0
    for cnt, op in re.findall(r"(\d+)([MIDNSHP=XB])", cig):
        cnt = int(cnt)
        if op in ("M", "=", "X"):
            for _ in range(cnt):
                score += int(m.data[m.mapper[q[qi]], m.mapper[r[ri]]])
                qi += 1
                ri += 1
        elif op == "I":   # consumes query
            score -= open_ + (cnt - 1) * ext
            qi += cnt
        elif op == "D":   # consumes reference
            score -= open_ + (cnt - 1) * ext
            ri += cnt
    return score


def test_ssw_windowed_zero_score_pair():
    m = Matrix.create(b"ACGT", 1, -1)
    al = Aligner.new().matrix(m).gap_open(5).gap_extend(2).build()
    res = al.ssw_batch([b"AAAA"], [b"TTTT"], windowed=True)
    assert res[0].score1 == 0
    assert res[0].cigar_len() == 0


def test_width64_exceeds_int32_exact():
    """width='64' is honored exactly: pairs whose score bound exceeds
    int32 are re-filled in int64 by the golden model (the reference's
    _64 kernels: src/aligner/mod.rs:331).  A 300bp perfect match at
    match=+10^7 scores 3e9 > INT32_MAX."""
    from parasail_rs_tpu.engine.dispatch import width64_risk

    m = Matrix.create(b"ACGT", 10_000_000, -1)
    q = b"ACGT" * 75                       # 300 bp
    small = b"ACGT" * 4
    a64 = (Aligner.new().matrix(m).gap_open(5).gap_extend(1).global_()
           .solution_width(64).use_stats().build())
    res, res_small = a64.align_batch([q, small], [q, small])
    assert res.get_score() == 300 * 10_000_000  # > 2**31: int64 honored
    assert res.get_end_query() == 299 and res.get_end_ref() == 299
    assert res.get_matches() == 300 and res.get_length() == 300
    assert not res.is_saturated()
    # the small pair in the same batch keeps the kernel result
    assert res_small.get_score() == 16 * 10_000_000
    g = golden.align_seqs(q, q, m, 5, 1, "nw")
    assert res.get_score() == g.score

    # sane inputs never trip the bound: the int32 kernel serves them
    batch, _, _ = (Aligner.new().matrix(Matrix.from_name("blosum62"))
                   .gap_open(5).gap_extend(1).solution_width(64).build()
                   ._pack([b"ARND"], [b"ARND"]))
    assert width64_risk(batch, 5, 1).size == 0


def test_width64_trace_and_rowcol_merge():
    """The int64 merge covers trace and rowcol output classes too."""
    m = Matrix.create(b"ACGT", 8_000_000, -8_000_000)
    q, r = b"ACGTACGTACGTACGTACGTACGTACGTACGTACGT" * 6, b"ACGTTT" * 36
    a = (Aligner.new().matrix(m).gap_open(5).gap_extend(1).local()
         .solution_width(64).use_trace().build())
    res = a.align(q, r)
    g = golden.align_seqs(q, r, m, 5, 1, "sw")
    assert res.get_score() == g.score
    assert res.get_cigar(q, r) == golden.walk_trace(
        g.trace_table, q, r, g.end_query, g.end_ref, "sw").cigar_string()
    a2 = (Aligner.new().matrix(m).gap_open(5).gap_extend(1).global_()
          .solution_width(64).use_last_rowcol().build())
    res2 = a2.align(q, r)
    g2 = golden.align_seqs(q, r, m, 5, 1, "nw")
    np.testing.assert_array_equal(
        np.asarray(res2.get_score_row()), g2.score_table[-1, :])
    np.testing.assert_array_equal(
        np.asarray(res2.get_score_col()), g2.score_table[:, -1])
