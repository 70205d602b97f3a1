"""Exact-NCBI-matrix registration and the approximate/slow-path signals.

Registered NCBI data must resolve with ``approximate=False`` and
override synthesis; synthesised builtins must be loud (Aligner build
warning, result property); and batches falling off the kernel route must
be logged and counted with a reason.
"""

import logging

import numpy as np
import pytest

from parasail_rs_tpu.engine import Aligner
from parasail_rs_tpu.engine.dispatch import (
    ROUTE_COUNTS, choose_route, pack_pairs, plan_route)
from parasail_rs_tpu.matrices import (
    Matrix, register_exact, register_ncbi_dir)
from parasail_rs_tpu.matrices import data as mdata
from parasail_rs_tpu.matrices import ncbi
from parasail_rs_tpu.matrices.data import PROTEIN_ALPHABET


@pytest.fixture
def clean_registry():
    saved = dict(mdata.EXACT_OVERRIDES)
    yield
    mdata.EXACT_OVERRIDES.clear()
    mdata.EXACT_OVERRIDES.update(saved)


def _ncbi_file_text(data: np.ndarray, order: str = PROTEIN_ALPHABET) -> str:
    """Render 24x24 data as an NCBI matrix file in the given column order."""
    canon = {c: i for i, c in enumerate(PROTEIN_ALPHABET)}
    lines = ["# test matrix in NCBI format", "   " + "  ".join(order)]
    for ci in order:
        row = [str(int(data[canon[ci], canon[cj]])) for cj in order]
        lines.append(ci + " " + " ".join(row))
    return "\n".join(lines) + "\n"


def test_parse_ncbi_file_roundtrip(tmp_path):
    base = Matrix.from_name("blosum62").data
    p = tmp_path / "BLOSUM62"
    p.write_text(_ncbi_file_text(base))
    assert (ncbi.parse_ncbi_file(p) == base).all()


def test_parse_ncbi_file_reorders_columns(tmp_path):
    base = Matrix.from_name("blosum62").data
    shuffled = "CWYVBZX*ARNDQEGHILKMFPST"
    p = tmp_path / "BLOSUM62"
    p.write_text(_ncbi_file_text(base, order=shuffled))
    assert (ncbi.parse_ncbi_file(p) == base).all()


def test_register_ncbi_dir_overrides_synthesis(tmp_path, clean_registry):
    # a distinctive fake table in valid NCBI format, registered as blosum40
    fake = Matrix.from_name("blosum62").data.copy()
    fake[0, 0] = 9
    (tmp_path / "BLOSUM40").write_text(_ncbi_file_text(fake))
    (tmp_path / "README").write_text("not a matrix\n")
    names = register_ncbi_dir(tmp_path)
    assert names == ["blosum40"]
    m = Matrix.from_name("blosum40")
    assert m.approximate is False
    assert (m.data == fake).all()


def test_unregistered_builtin_stays_flagged(clean_registry):
    mdata.EXACT_OVERRIDES.pop("blosum40", None)
    assert Matrix.from_name("blosum40").approximate is True
    # anchors are verbatim regardless
    for name in ("blosum45", "blosum50", "blosum62", "blosum80",
                 "blosum90", "pam250"):
        assert Matrix.from_name(name).approximate is False


def test_register_exact_validates(clean_registry):
    with pytest.raises(ValueError):
        register_exact("notamatrix", np.zeros((24, 24), np.int32))
    with pytest.raises(ValueError):
        register_exact("blosum40", np.zeros((4, 4), np.int32))


def test_autoload_from_env(tmp_path, monkeypatch, clean_registry):
    fake = Matrix.from_name("blosum62").data.copy()
    fake[1, 1] = 11
    (tmp_path / "PAM120").write_text(_ncbi_file_text(fake))
    monkeypatch.setenv("PT_NCBI_MATRICES", str(tmp_path))
    monkeypatch.setattr(ncbi, "_AUTOLOADED", False)
    m = Matrix.from_name("pam120")
    assert m.approximate is False
    assert (m.data == fake).all()


def test_aligner_warns_on_approximate_matrix(caplog, clean_registry):
    mdata.EXACT_OVERRIDES.pop("blosum40", None)
    approx = Matrix.from_name("blosum40")
    with caplog.at_level(logging.WARNING, logger="parasail_rs_tpu"):
        a = Aligner.new().matrix(approx).gap_open(10).gap_extend(1).build()
    assert any("synthesised builtin matrix" in r.message
               for r in caplog.records)
    assert a.matrix_approximate is True

    caplog.clear()
    exact = Matrix.from_name("blosum62")
    with caplog.at_level(logging.WARNING, logger="parasail_rs_tpu"):
        a2 = Aligner.new().matrix(exact).gap_open(10).gap_extend(1).build()
    assert not any("synthesised" in r.message for r in caplog.records)
    assert a2.matrix_approximate is False


def test_result_matrix_approximate_property(clean_registry):
    mdata.EXACT_OVERRIDES.pop("blosum40", None)
    approx = Matrix.from_name("blosum40")
    a = Aligner.new().matrix(approx).gap_open(10).gap_extend(1).local().build()
    res = a.align(b"ARNDARND", b"ARNDCARND")
    assert res.matrix_approximate is True
    exact = Aligner.new().matrix(Matrix.from_name("blosum62")) \
        .gap_open(10).gap_extend(1).local().build()
    assert exact.align(b"ARNDARND", b"ARNDCARND").matrix_approximate is False


def test_plan_route_reports_reasons():
    m = Matrix.from_name("blosum62")
    batch, _, _ = pack_pairs(m, [b"ARND"], [b"ARND"])
    # without a GPU the disqualifier is the backend
    route, reason = plan_route(batch, "score")
    assert route == "wavefront"
    assert "backend is" in reason
    # on a GPU: output classes and shapes beyond the kernel say so
    route, reason = choose_route("table", 16, 16, platform="gpu")
    assert route == "wavefront"
    assert "no kernel for table at 16x16" in reason
    route, reason = choose_route("stats", 512, 16, platform="gpu")
    assert route == "wavefront"
    assert "512x16" in reason
    assert choose_route("stats", batch.qp, batch.rp,
                        platform="gpu") == ("kernel", "")


def test_aligner_route_counter_and_log(caplog):
    m = Matrix.from_name("blosum62")
    # without a GPU every batch lands on the wavefront, with a reason
    a = (Aligner.new().matrix(m).gap_open(1).gap_extend(2).local()
         .use_stats().build())
    before = sum(ROUTE_COUNTS.values())
    with caplog.at_level(logging.INFO, logger="parasail_rs_tpu"):
        a.align(b"ARNDARND", b"ARNDCARND")
    assert sum(a.route_counter.values()) == 1
    (route, reason), = a.route_counter.keys()
    assert route == "wavefront"
    assert "backend is" in reason
    assert sum(ROUTE_COUNTS.values()) == before + 1
    assert any("routed to" in r.message for r in caplog.records)


def test_register_ncbi_dir_ignores_scaled_variants(tmp_path, clean_registry):
    """The stock NCBI ftp layout ships rescaled variants under dotted
    suffixes (BLOSUM62.50 = half-bit units); only the canonical file may
    register — a variant must never overwrite it under the exact flag."""
    base = Matrix.from_name("blosum62").data
    scaled = base * 2
    (tmp_path / "BLOSUM62").write_text(_ncbi_file_text(base))
    (tmp_path / "BLOSUM62.50").write_text(_ncbi_file_text(scaled))
    (tmp_path / "BLOSUM50.txt").write_text(_ncbi_file_text(base))
    found = register_ncbi_dir(tmp_path)
    assert found == ["blosum62"]
    m = Matrix.from_name("blosum62")
    assert not m.approximate
    np.testing.assert_array_equal(m.data, base)
