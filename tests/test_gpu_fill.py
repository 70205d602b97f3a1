"""GPU DP-fill kernel (ops/gpu_fill.py) in interpret mode.

The kernel runs through the Pallas interpreter on the CPU and must be
bit-identical to the XLA wavefront (itself pinned to the golden model by
tests/test_wavefront.py) for every mode, free-end variant, output class
and penalty regime, and to golden directly through the engine's kernel
route (dispatch._execute_kernel) for every substitution source: the
square table, a shared query profile, per-pair profile rows and a PSSM.
"""

import numpy as np
import pytest

from parasail_rs_tpu.engine import Aligner, Profile
from parasail_rs_tpu.engine.dispatch import (
    _execute_kernel, build_batch, pack_pairs)
from parasail_rs_tpu.engine.profile import profile_rows
from parasail_rs_tpu.golden import model as golden
from parasail_rs_tpu.matrices import Matrix
from parasail_rs_tpu.ops.gpu_fill import (
    MAX_QP, block_config, dp_fill, scalar_names, stats_fields, supports)
from parasail_rs_tpu.ops.wavefront import wavefront_align

AA = list(b"ARNDCQEGHILKMFPSTWYV")
DNA = list(b"ACGT")
B62 = Matrix.from_name("blosum62")

CONFIGS = [
    ("sw", (True, True, True, True)),
    ("nw", (False, False, False, False)),
    ("sg", (True, True, True, True)),
    ("sg", (True, False, False, True)),
    ("sg", (False, True, True, False)),
    ("sg", (False, False, False, False)),
]


def _seqs(rng, alpha, n, lo, hi):
    return [rng.choice(alpha, size=int(rng.integers(lo, hi + 1)))
            .astype("uint8").tobytes() for _ in range(n)]


def _arrays(m, qs, rs, Qp=None, Rp=None):
    """Table-path kernel inputs and the wavefront's profile rows."""
    B = len(qs)
    Qp = Qp or -(-max(map(len, qs)) // 8) * 8
    Rp = Rp or max(map(len, rs))
    A = m.size
    qidx = np.full((B, Qp), -1, np.int32)
    ridx = np.zeros((B, Rp), np.int32)
    for b, (q, r) in enumerate(zip(qs, rs)):
        qidx[b, :len(q)] = m.encode(q)
        ridx[b, :len(r)] = m.encode(r)
    table = np.asarray(m.data, np.int32)
    qoff = np.clip(qidx, 0, A - 1) * A
    prof = table[np.clip(qidx, 0, A - 1)]
    qlen = np.array([len(q) for q in qs], np.int32)
    rlen = np.array([len(r) for r in rs], np.int32)
    return table, qoff, qidx, ridx, qlen, rlen, prof


def _batch(seed=0, n=12, lo=1, hi=22, alpha=AA, m=B62):
    rng = np.random.default_rng(seed)
    qs = _seqs(rng, alpha, n, lo, hi)
    rs = _seqs(rng, alpha, n, lo, hi)
    return qs, rs, _arrays(m, qs, rs)


BATCH = _batch()


def _compare(packed, big, ref, width, outputs, qlen, rlen):
    names = scalar_names(width, outputs == "stats")
    for k, name in enumerate(names):
        np.testing.assert_array_equal(
            np.asarray(packed[k]), np.asarray(ref[name]).astype(np.int32),
            err_msg=name)
    if outputs == "trace":
        got, want = np.asarray(big["trace_table"]), np.asarray(
            ref["trace_table"])
        for b in range(len(qlen)):
            np.testing.assert_array_equal(
                got[b, :qlen[b], :rlen[b]], want[b, :qlen[b], :rlen[b]])


@pytest.mark.parametrize("open_,ext", [(11, 1), (1, 3)])
@pytest.mark.parametrize("outputs", ["score", "stats", "trace"])
@pytest.mark.parametrize("mode,free", CONFIGS)
def test_kernel_matches_wavefront(mode, free, outputs, open_, ext):
    _, _, (table, qoff, qidx, ridx, qlen, rlen, prof) = BATCH
    ref = wavefront_align(prof, qidx, ridx, qlen, rlen,
                          open_=np.int32(open_), ext=np.int32(ext),
                          mode=mode, free=free, outputs=outputs, width="sat")
    packed, big = dp_fill(table, qoff, qidx, ridx, qlen, rlen,
                          np.array([open_, ext], np.int32), mode=mode,
                          free=free, outputs=outputs, width="sat",
                          block=(8, 8, 1), interpret=True)
    _compare(packed, big, ref, "sat", outputs, qlen, rlen)


@pytest.mark.parametrize("width", ["8", "16", "sat", "32"])
@pytest.mark.parametrize("mode", ["sw", "nw"])
def test_kernel_saturation_flags(width, mode):
    """Narrow widths flag exactly the pairs whose H leaves the width's
    range; scores stay exact."""
    m = Matrix.create(b"ACGT", 90, -70)
    qs, rs, (table, qoff, qidx, ridx, qlen, rlen, prof) = _batch(
        seed=3, n=10, lo=1, hi=20, alpha=DNA, m=m)
    free = golden.free_flags(mode)
    ref = wavefront_align(prof, qidx, ridx, qlen, rlen, open_=np.int32(5),
                          ext=np.int32(2), mode=mode, free=free,
                          outputs="score", width=width)
    packed, big = dp_fill(table, qoff, qidx, ridx, qlen, rlen,
                          np.array([5, 2], np.int32), mode=mode, free=free,
                          outputs="score", width=width, block=(8, 8, 1),
                          interpret=True)
    _compare(packed, big, ref, width, "score", qlen, rlen)
    if width == "8":
        assert np.asarray(ref["saturated"]).any()


@pytest.mark.parametrize("block", [(8, 32, 1), (16, 32, 1), (8, 64, 2)])
def test_kernel_block_configs(block):
    """Strip height and lanes per program do not change results."""
    _, _, (table, qoff, qidx, ridx, qlen, rlen, prof) = _batch(
        seed=5, n=40, lo=1, hi=32)
    ref = wavefront_align(prof, qidx, ridx, qlen, rlen, open_=np.int32(10),
                          ext=np.int32(1), mode="sw", free=(True,) * 4,
                          outputs="score", width="sat")
    packed, big = dp_fill(table, qoff, qidx, ridx, qlen, rlen,
                          np.array([10, 1], np.int32), mode="sw",
                          free=(True,) * 4, outputs="score", width="sat",
                          block=block, interpret=True)
    _compare(packed, big, ref, "sat", "score", qlen, rlen)


@pytest.mark.parametrize("B", [1, 9, 33])
def test_kernel_batch_padding(B):
    """Batches that do not fill the last program's lanes are padded and
    sliced back; padded lanes never leak into results."""
    rng = np.random.default_rng(B)
    qs = _seqs(rng, AA, B, 3, 20)
    rs = _seqs(rng, AA, B, 3, 20)
    table, qoff, qidx, ridx, qlen, rlen, prof = _arrays(B62, qs, rs)
    packed, big = dp_fill(table, qoff, qidx, ridx, qlen, rlen,
                          np.array([11, 1], np.int32), mode="sg",
                          free=(True,) * 4, outputs="trace", width="sat",
                          block=(8, 32, 1), interpret=True)
    assert packed.shape == (len(scalar_names("sat", False)), B)
    assert big["trace_table"].shape == (B, qoff.shape[1], ridx.shape[1])
    ref = wavefront_align(prof, qidx, ridx, qlen, rlen, open_=np.int32(11),
                          ext=np.int32(1), mode="sg", free=(True,) * 4,
                          outputs="trace", width="sat")
    _compare(packed, big, ref, "sat", "trace", qlen, rlen)


def _golden_rows(pairs, m, open_, ext, mode, free):
    return [golden.align_seqs(q, r, m, open_, ext, mode, free)
            for q, r in pairs]


def _check_golden(out, gs, stats):
    for b, g in enumerate(gs):
        got = [int(out["score"][b]), int(out["end_query"][b]),
               int(out["end_ref"][b])]
        want = [g.score, g.end_query, g.end_ref]
        if stats:
            got += [int(out[k][b]) for k in ("matches", "similar", "length")]
            want += [g.matches, g.similar, g.length]
        assert got == want, b


@pytest.mark.parametrize("open_,ext", [(11, 1), (2, 2), (1, 4)])
def test_route_table_path_vs_golden(open_, ext):
    """pack_pairs batches ship raw bytes and the (A, A) table."""
    rng = np.random.default_rng(open_)
    qs = _seqs(rng, AA, 7, 2, 30)
    rs = _seqs(rng, AA, 7, 2, 30)
    batch, _, _ = pack_pairs(B62, qs, rs)
    assert batch.table is not None and batch.qbytes is not None
    out = _execute_kernel(batch, gap_open=open_, gap_extend=ext, mode="sg",
                          free=(True, False, True, False), width="sat",
                          outputs="stats", interpret=True)
    _check_golden(out, _golden_rows(zip(qs, rs), B62, open_, ext, "sg",
                                    (True, False, True, False)), True)


def test_route_shared_profile_vs_golden():
    """A Profile (one query, many references) broadcasts its rows."""
    rng = np.random.default_rng(21)
    q = _seqs(rng, AA, 1, 20, 20)[0]
    rs = _seqs(rng, AA, 9, 5, 30)
    prof = Profile.new(q, True, B62)
    batch, _, _ = pack_pairs(B62, None, rs, profile=prof)
    assert batch.shared_query
    out = _execute_kernel(batch, gap_open=10, gap_extend=1, mode="sw",
                          free=(True,) * 4, width="sat", outputs="stats",
                          interpret=True)
    _check_golden(out, _golden_rows([(q, r) for r in rs], B62, 10, 1, "sw",
                                    None), True)


def test_route_per_pair_profile_vs_golden():
    """build_batch batches carry (B, Qp, A) profile rows per pair."""
    rng = np.random.default_rng(22)
    qs = _seqs(rng, AA, 6, 3, 20)
    rs = _seqs(rng, AA, 6, 3, 20)
    batch = build_batch([profile_rows(B62, B62.encode(q)) for q in qs],
                        [B62.encode(q) for q in qs],
                        [B62.encode(r) for r in rs])
    out = _execute_kernel(batch, gap_open=7, gap_extend=2, mode="nw",
                          free=(False,) * 4, width="32", outputs="stats",
                          interpret=True)
    _check_golden(out, _golden_rows(zip(qs, rs), B62, 7, 2, "nw", None),
                  True)


def test_route_pssm_vs_golden():
    """Position-indexed PSSM rows are shared by the batch."""
    m = Matrix.create(b"ACGT", 3, -2).to_pssm(b"ACGTACGTAC")
    rng = np.random.default_rng(23)
    qs = [b"ACGTACGTAC"] * 5
    rs = _seqs(rng, DNA, 5, 4, 16)
    batch, _, _ = pack_pairs(m, qs, rs)
    out = _execute_kernel(batch, gap_open=4, gap_extend=1, mode="sw",
                          free=(True,) * 4, width="sat", outputs="score",
                          interpret=True)
    _check_golden(out, _golden_rows(zip(qs, rs), m, 4, 1, "sw", None),
                  False)


def test_route_trace_cigars_vs_golden():
    """Kernel trace flags walk to golden's CIGARs."""
    rng = np.random.default_rng(24)
    qs = _seqs(rng, DNA, 6, 5, 24)
    rs = _seqs(rng, DNA, 6, 5, 24)
    m = Matrix.create(b"ACGT", 2, -3)
    batch, ql, rl = pack_pairs(m, qs, rs)
    out = _execute_kernel(batch, gap_open=5, gap_extend=2, mode="sw",
                          free=(True,) * 4, width="sat", outputs="trace",
                          interpret=True)
    for b, (q, r) in enumerate(zip(qs, rs)):
        g = golden.align_seqs(q, r, m, 5, 2, "sw")
        w = golden.walk_trace(out["trace_table"][b, :ql[b], :rl[b]], q, r,
                              int(out["end_query"][b]),
                              int(out["end_ref"][b]), "sw")
        gw = golden.walk_trace(g.trace_table, q, r, g.end_query, g.end_ref,
                               "sw")
        assert w.cigar_string() == gw.cigar_string()


def test_kernel_large_scores_exact():
    """Entries beyond +/-2048 stay exact (integer gathers, no float
    matmul)."""
    m = Matrix.create(b"ACGT", 3000, -2500)
    rng = np.random.default_rng(25)
    qs = _seqs(rng, DNA, 6, 5, 20)
    rs = _seqs(rng, DNA, 6, 5, 20)
    batch, _, _ = pack_pairs(m, qs, rs)
    out = _execute_kernel(batch, gap_open=4000, gap_extend=700, mode="sg",
                          free=(True,) * 4, width="32", outputs="stats",
                          interpret=True)
    _check_golden(out, _golden_rows(zip(qs, rs), m, 4000, 700, "sg", None),
                  True)


def test_fetch_false_returns_pending():
    batch, _, _ = pack_pairs(B62, [b"ARND"], [b"ARNDC"])
    pend = _execute_kernel(batch, gap_open=11, gap_extend=1, mode="sw",
                           free=(True,) * 4, width="sat", outputs="score",
                           fetch=False, interpret=True)
    out = pend.fetch()
    assert int(out["score"][0]) == golden.align_seqs(
        b"ARND", b"ARNDC", B62, 11, 1, "sw").score
    assert out["saturated"].dtype == bool


@pytest.mark.parametrize("qp,rp,ok", [
    (16, 16, True), (256, 256, True), (192, 16384, True),
    (256, 1 << 20, False), (8, 5, True)])
def test_stats_fields(qp, rp, ok):
    f = stats_fields(qp, rp)
    assert (f is not None) == ok
    if ok:
        shm, shs = f
        # m and s count diagonal steps (<= qp), l counts columns
        assert (qp << shm) < (1 << 31)
        assert shs >= (qp + rp).bit_length()
        assert shm - shs >= qp.bit_length()


@pytest.mark.parametrize("outputs,qp,rp,banded,ok", [
    ("score", 192, 192, False, True),
    ("trace", 256, 4096, False, True),
    ("stats", 64, 64, False, True),
    ("score", MAX_QP + 8, 64, False, False),
    ("table", 64, 64, False, False),
    ("rowcol", 64, 64, False, False),
    ("score", 64, 64, True, False),
    ("score", 20, 64, False, False),
])
def test_supports(outputs, qp, rp, banded, ok):
    assert supports(outputs, qp, rp, banded) is ok


def test_scalar_names_and_block_config():
    assert scalar_names("sat", False) == (
        "end_query", "end_ref", "promoted", "saturated", "score")
    assert scalar_names("32", True) == (
        "end_query", "end_ref", "length", "matches", "saturated", "score",
        "similar")
    assert block_config(192, "score") == (16, 32, 1)
    assert block_config(24, "score")[0] == 8
    assert block_config(192, "stats")[0] == 8


def test_aligner_kernel_free_path_matches_public():
    """The public align_batch (whatever route serves it) and the kernel
    route agree on a mixed batch."""
    rng = np.random.default_rng(26)
    qs = _seqs(rng, AA, 10, 1, 40)
    rs = _seqs(rng, AA, 10, 1, 40)
    al = Aligner.new().matrix(B62).gap_open(11).gap_extend(1).local() \
        .use_stats().build()
    res = al.align_batch(qs, rs)
    batch, _, _ = al._pack(qs, rs)
    out = _execute_kernel(batch, gap_open=11, gap_extend=1, mode="sw",
                          free=al.key.free, width=al.key.width,
                          outputs="stats", interpret=True)
    for b, a in enumerate(res):
        assert (a.get_score(), a.get_end_query(), a.get_end_ref(),
                a.get_matches(), a.get_similar(), a.get_length(),
                a.is_saturated()) == tuple(
            int(out[k][b]) for k in ("score", "end_query", "end_ref",
                                     "matches", "similar", "length",
                                     "saturated"))


@pytest.mark.parametrize("outputs", ["score", "stats"])
@pytest.mark.parametrize("mode", ["global_", "semi_global", "local"])
def test_kernel_empty_sequences_match_wavefront(mode, outputs):
    """Empty queries or references keep the wavefront's results,
    sentinels included."""
    from parasail_rs_tpu.engine.dispatch import execute

    b = getattr(Aligner.new().gap_open(3).gap_extend(1), mode)()
    al = (b.use_stats() if outputs == "stats" else b).build()
    batch, _, _ = al._pack([b"", b"A", b"ACGT", b""],
                           [b"ACG", b"", b"T", b""])
    kw = dict(gap_open=3, gap_extend=1, mode=al.key.mode, free=al.key.free,
              width=al.key.width, outputs=outputs)
    got = _execute_kernel(batch, interpret=True, **kw)
    want = execute(batch, **kw)
    for k in got:
        np.testing.assert_array_equal(
            np.asarray(got[k]).astype(np.int64),
            np.asarray(want[k]).astype(np.int64), err_msg=k)
