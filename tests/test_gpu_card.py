"""Card tests: the compiled GPU kernel on an NVIDIA GPU.

Run on the card with ``python -m pytest -m gpu``; elsewhere they skip
(the ``gpu`` fixture decides at run time).  The kernel is compiled by
Triton here, never interpreted, and compared with the XLA wavefront on
the same card and with golden/model.py.
"""

import numpy as np
import pytest

from parasail_rs_tpu.engine import Aligner, dispatch
from parasail_rs_tpu.golden import model as golden
from parasail_rs_tpu.matrices import Matrix
from parasail_rs_tpu.utils.workloads import DNA, PROTEIN, homologous_pairs

pytestmark = pytest.mark.gpu

B62 = Matrix.from_name("blosum62")


def _builder(mode, open_, ext, m=B62):
    b = Aligner.new().matrix(m).gap_open(open_).gap_extend(ext)
    return {"nw": b.global_, "sg": b.semi_global, "sw": b.local}[mode]()


@pytest.mark.parametrize("outputs", ["score", "stats", "trace"])
@pytest.mark.parametrize("mode", ["nw", "sg", "sw"])
def test_compiled_kernel_matches_wavefront(gpu, mode, outputs):
    pairs = homologous_pairs(np.random.default_rng(1), 1024, 140, 160,
                             PROTEIN)
    qs, rs = (list(x) for x in zip(*pairs))
    al = _builder(mode, 11, 1).build()
    batch, ql, rl = al._pack(qs, rs)
    assert dispatch.plan_route(batch, outputs)[0] == "kernel"
    kw = dict(gap_open=11, gap_extend=1, mode=mode, free=al.key.free,
              width="sat", outputs=outputs)
    got = dispatch._execute_kernel(batch, **kw)
    want = {k: np.asarray(v) for k, v in dispatch._wavefront_exec(
        batch, **kw).items()}
    for k, v in got.items():
        if k == "trace_table":
            for b in range(len(qs)):
                np.testing.assert_array_equal(
                    v[b, :ql[b], :rl[b]], want[k][b, :ql[b], :rl[b]])
        else:
            np.testing.assert_array_equal(v, want[k], err_msg=k)


@pytest.mark.parametrize("open_,ext", [(11, 1), (1, 2)])
def test_public_stats_equal_golden_on_card(gpu, open_, ext):
    pairs = homologous_pairs(np.random.default_rng(2), 64, 140, 160,
                             PROTEIN)
    al = _builder("sg", open_, ext).use_stats().build()
    res = al.align_batch(*(list(x) for x in zip(*pairs)))
    for a, (q, r) in zip(res, pairs):
        g = golden.align_seqs(q, r, B62, open_, ext, "sg")
        assert (a.get_score(), a.get_end_query(), a.get_end_ref(),
                a.get_matches(), a.get_similar(), a.get_length()) == (
            g.score, g.end_query, g.end_ref, g.matches, g.similar,
            g.length)


def test_large_scores_exact_on_card(gpu):
    """Entries beyond +/-2048 survive the card (no TF32 rounding)."""
    m = Matrix.create(DNA, 3000, -2500)
    pairs = homologous_pairs(np.random.default_rng(3), 64, 100, 150, DNA)
    for mode in ("sw", "sg", "nw"):
        al = _builder(mode, 4000, 700, m).use_stats().build()
        res = al.align_batch(*(list(x) for x in zip(*pairs)))
        for a, (q, r) in zip(res, pairs):
            g = golden.align_seqs(q, r, m, 4000, 700, mode)
            assert (a.get_score(), a.get_matches(), a.get_length()) == (
                g.score, g.matches, g.length)


def test_align_cigars_on_card(gpu):
    m = Matrix.create(DNA, 2, -3)
    pairs = homologous_pairs(np.random.default_rng(4), 128, 150, 150, DNA,
                             sub_rate=0.02, indel_rate=0.005, flank=10)
    al = Aligner.new().matrix(m).gap_open(5).gap_extend(2).semi_global() \
        .build()
    alns, cigs = al.align_cigars(*(list(x) for x in zip(*pairs)))
    for c, (q, r) in zip(cigs, pairs):
        g = golden.align_seqs(q, r, m, 5, 2, "sg")
        w = golden.walk_trace(g.trace_table, q, r, g.end_query, g.end_ref,
                              "sg", golden.free_flags("sg"))
        assert c == w.cigar_string()
