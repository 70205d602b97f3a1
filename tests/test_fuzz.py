"""Randomized engine-level fuzzing vs the golden oracle.

Sweeps gap-penalty regimes — open > ext, open == ext and open < ext,
where golden's gap-restart tie rules decide stats and trace flags — plus
degenerate lengths, all through the public API.  Also fuzzes align_cigars (the device traceback walk)
against per-pair get_cigar for every mode and regime.
"""

import numpy as np
import pytest

from parasail_rs_tpu.engine import Aligner
from parasail_rs_tpu.golden import model as golden
from parasail_rs_tpu.matrices import Matrix


MODES = [("global_", "nw"), ("semi_global", "sg"), ("local", "sw")]


@pytest.mark.parametrize("open_,ext", [(11, 1), (4, 4), (1, 3), (0, 0)])
def test_fuzz_scores_and_stats(open_, ext):
    rng = np.random.default_rng(open_ * 31 + ext)
    m = Matrix.create(b"ACGT", 3, -2)
    qs, rs = [], []
    for _ in range(24):
        qs.append(rng.choice(list(b"ACGT"),
                             size=rng.integers(1, 50)).astype("uint8").tobytes())
        rs.append(rng.choice(list(b"ACGT"),
                             size=rng.integers(1, 50)).astype("uint8").tobytes())
    for setter, mode in MODES:
        builder = (Aligner.new().matrix(m).gap_open(open_).gap_extend(ext)
                   .use_stats())
        getattr(builder, setter)()
        aligner = builder.build()
        for q, r, res in zip(qs, rs, aligner.align_batch(qs, rs)):
            g = golden.align_seqs(q, r, m, open_, ext, mode)
            assert res.get_score() == g.score, (mode, open_, ext, q, r)
            assert res.get_end_query() == g.end_query, (mode, q, r)
            assert res.get_end_ref() == g.end_ref, (mode, q, r)
            assert res.get_matches() == g.matches, (mode, q, r)
            assert res.get_similar() == g.similar, (mode, q, r)
            assert res.get_length() == g.length, (mode, q, r)


def test_fuzz_cigars_roundtrip():
    # CIGAR consumption must reconstruct the end coordinates exactly.
    rng = np.random.default_rng(77)
    m = Matrix.from_name("blosum62")
    aligner = (Aligner.new().matrix(m).gap_open(10).gap_extend(2)
               .semi_global().use_trace().build())
    alpha = list(b"ARNDCQEGHILKMFPSTWYV")
    for _ in range(20):
        q = rng.choice(alpha, size=rng.integers(2, 40)).astype("uint8").tobytes()
        r = rng.choice(alpha, size=rng.integers(2, 40)).astype("uint8").tobytes()
        res = aligner.align(q, r)
        walk = res._walk(q, r)
        qi, ri = walk.beg_query, walk.beg_ref
        for n, op in walk.ops:
            if op in ("=", "X"):
                qi += n
                ri += n
            elif op == "I":
                qi += n
            else:
                ri += n
        assert qi - 1 == res.get_end_query(), (q, r)
        assert ri - 1 == res.get_end_ref(), (q, r)
        g = golden.align_seqs(q, r, m, 10, 2, "sg")
        gw = golden.walk_trace(g.trace_table, q, r, g.end_query, g.end_ref, "sg")
        assert res.get_cigar(q, r) == gw.cigar_string(), (q, r)


def test_single_char_and_empty_edge_cases():
    aligner = Aligner.new().local().gap_open(1).gap_extend(1).build()
    res = aligner.align(b"A", b"A")
    assert res.get_score() == 1
    res = aligner.align(b"A", b"C")
    assert res.get_score() == 0  # empty local alignment
    assert res.get_end_query() == 0 and res.get_end_ref() == 0


def test_cigar_score_reconstruction():
    # Walking the emitted CIGAR and re-scoring it from the matrix and
    # penalties must reproduce the kernel's score exactly — a
    # self-consistency invariant tying trace tables, CIGARs, and scores.
    rng = np.random.default_rng(97)
    m = Matrix.from_name("blosum62")
    for mode_setter, mode in MODES:
        builder = (Aligner.new().matrix(m).gap_open(10).gap_extend(2)
                   .use_trace())
        getattr(builder, mode_setter)()
        aligner = builder.build()
        alpha = list(b"ARNDCQEGHILKMFPSTWYV")
        for _ in range(15):
            q = rng.choice(alpha,
                           size=rng.integers(2, 45)).astype("uint8").tobytes()
            r = rng.choice(alpha,
                           size=rng.integers(2, 45)).astype("uint8").tobytes()
            res = aligner.align(q, r)
            walk = res._walk(q, r)
            qi, ri = walk.beg_query, walk.beg_ref
            score = 0
            for n, op in walk.ops:
                if op in ("=", "X"):
                    for _ in range(n):
                        score += int(m.scores_for(
                            m.encode(q[qi:qi + 1]),
                            m.encode(r[ri:ri + 1]))[0, 0])
                        qi += 1
                        ri += 1
                else:
                    score += -(10 + 2 * (n - 1))
                    if op == "I":
                        qi += n
                    else:
                        ri += n
            # free-end overhang is excluded from the walk by
            # construction, so the re-scored ops equal the kernel score
            # in every mode
            assert score == res.get_score(), (mode, q, r, score,
                                              res.get_score())


@pytest.mark.parametrize("open_,ext", [(11, 1), (4, 4), (1, 3), (0, 0),
                                       (0, 5), (3, 3)])
def test_fuzz_align_cigars_all_modes(open_, ext):
    """align_cigars (device traceback walk) == per-pair get_cigar for
    random pairs across every mode and penalty regime, incl. degenerate
    single-char sequences."""
    rng = np.random.default_rng(1000 + open_ * 13 + ext)
    m = Matrix.create(b"ACGT", 3, -2)
    qs = [rng.choice(list(b"ACGT"),
                     size=rng.integers(1, 40)).astype("uint8").tobytes()
          for _ in range(16)]
    rs = [rng.choice(list(b"ACGT"),
                     size=rng.integers(1, 40)).astype("uint8").tobytes()
          for _ in range(16)]
    for setter, mode in MODES:
        b1 = Aligner.new().matrix(m).gap_open(open_).gap_extend(ext)
        getattr(b1, setter)()
        tr = b1.use_trace().build()
        want = [a.get_cigar(q, r)
                for a, q, r in zip(tr.align_batch(qs, rs), qs, rs)]
        b2 = Aligner.new().matrix(m).gap_open(open_).gap_extend(ext)
        getattr(b2, setter)()
        alns, cigs = b2.build().align_cigars(qs, rs)
        assert cigs == want, (mode, open_, ext)
        for a, q, r in zip(alns, qs, rs):
            g = golden.align_seqs(q, r, m, open_, ext, mode)
            assert a.get_score() == g.score


def test_fuzz_stats_walk_route_widths():
    """Stats at open <= ext across solution widths (the width knob only
    affects saturation flags; counts stay golden-exact), on the public
    route and on the kernel route."""
    from parasail_rs_tpu.engine.dispatch import _execute_kernel

    rng = np.random.default_rng(404)
    m = Matrix.create(b"ACGT", 3, -2)
    qs = [rng.choice(list(b"ACGT"),
                     size=rng.integers(2, 30)).astype("uint8").tobytes()
          for _ in range(8)]
    rs = [rng.choice(list(b"ACGT"),
                     size=rng.integers(2, 30)).astype("uint8").tobytes()
          for _ in range(8)]
    for width in ("sat", 8, 16, 32, 64):
        al = (Aligner.new().matrix(m).gap_open(2).gap_extend(3)
              .solution_width(width).use_stats().local().build())
        res = al.align_batch(qs, rs)
        batch, _, _ = al._pack(qs, rs)
        kw = {"64": "32"}.get(str(width), str(width))
        out = _execute_kernel(batch, gap_open=2, gap_extend=3, mode="sw",
                              free=(True,) * 4, width=kw, outputs="stats",
                              interpret=True)
        for b, (a, q, r) in enumerate(zip(res, qs, rs)):
            g = golden.align_seqs(q, r, m, 2, 3, "sw")
            want = (g.score, g.matches, g.similar, g.length)
            assert (a.get_score(), a.get_matches(), a.get_similar(),
                    a.get_length()) == want, (width, q, r)
            assert tuple(int(out[k][b]) for k in (
                "score", "matches", "similar", "length")) == want
