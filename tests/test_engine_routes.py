"""Route choice, the device-memory guard, exact substitution scores, the
compile-cache helper, and a CPU dry run of chip_smoke.py's phases."""

import json

import jax
import numpy as np
import pytest

from parasail_rs_tpu.engine import Aligner, dispatch
from parasail_rs_tpu.engine.dispatch import choose_route, pack_pairs
from parasail_rs_tpu.matrices import Matrix
from parasail_rs_tpu.utils import compile_cache


@pytest.mark.parametrize("outputs,qp,rp,platform,route", [
    ("score", 192, 192, "gpu", "kernel"),
    ("stats", 192, 192, "gpu", "kernel"),
    ("trace", 256, 384, "gpu", "kernel"),
    ("stats", 192, 16384, "gpu", "kernel"),
    ("stats", 256, 1 << 20, "gpu", "wavefront"),
    ("score", 384, 192, "gpu", "wavefront"),
    ("table", 64, 64, "gpu", "wavefront"),
    ("stats_rowcol", 64, 64, "gpu", "wavefront"),
    ("score", 192, 192, "cpu", "wavefront"),
    ("trace", 64, 64, "cpu", "wavefront"),
])
def test_choose_route(outputs, qp, rp, platform, route):
    got, reason = choose_route(outputs, qp, rp, platform=platform)
    assert got == route
    assert (reason == "") == (route == "kernel")


def test_choose_route_banded_and_probe():
    assert choose_route("score", 64, 64, banded=True,
                        platform="gpu")[0] == "wavefront"
    # without a platform the one backend probe decides
    assert choose_route("score", 64, 64)[0] == (
        "kernel" if jax.default_backend() == "gpu" else "wavefront")


def test_plane_guard_refuses_before_allocating(monkeypatch):
    """A trace batch whose stacked planes exceed the device budget raises
    a clear error before any device work."""
    m = Matrix.create(b"ACGT", 2, -3)
    batch, _, _ = pack_pairs(m, [b"ACGT" * 8] * 4, [b"ACGT" * 8] * 4)
    need = dispatch._plane_bytes("wavefront", "trace", 4, batch.qp,
                                 batch.rp)
    monkeypatch.setattr(dispatch, "device_memory_budget", lambda: need - 1)
    with pytest.raises(MemoryError, match="trace planes for 4 pairs"):
        dispatch._wavefront_exec(batch, gap_open=5, gap_extend=2, mode="sw",
                                 free=(True,) * 4, outputs="trace",
                                 width="sat")
    al = Aligner.new().matrix(m).gap_open(5).gap_extend(2).use_trace() \
        .build()
    with pytest.raises(MemoryError):
        al.align_batch([b"ACGT" * 8] * 4, [b"ACGT" * 8] * 4)
    kneed = dispatch._plane_bytes("kernel", "trace", 4, batch.qp, batch.rp)
    monkeypatch.setattr(dispatch, "device_memory_budget", lambda: kneed - 1)
    with pytest.raises(MemoryError, match="on the kernel route"):
        dispatch._execute_kernel(batch, gap_open=5, gap_extend=2, mode="sw",
                                 free=(True,) * 4, width="sat",
                                 outputs="trace", interpret=True)
    # scalar classes hold no cell-sized planes: never refused
    out = dispatch._wavefront_exec(batch, gap_open=5, gap_extend=2,
                                   mode="sw", free=(True,) * 4,
                                   outputs="score", width="sat")
    assert int(out["score"][0]) == 64


@pytest.mark.parametrize("route,outputs,per_cell", [
    ("kernel", "trace", 2), ("wavefront", "score", 0),
    ("kernel", "score", 0)])
def test_plane_bytes(route, outputs, per_cell):
    assert dispatch._plane_bytes(route, outputs, 10, 16, 24) == \
        per_cell * 10 * 16 * 24
    # the wavefront stacks one (B, Qp) slab per anti-diagonal, then
    # gathers the plane
    assert dispatch._plane_bytes("wavefront", "table", 2, 8, 8) == \
        (8 + 8 - 1) * 2 * 8 * 4 + 2 * 8 * 8 * 4


def test_device_profile_is_an_exact_gather():
    table = np.array([[3000, -2500], [-2500, 2047]], np.int32) * 7
    qidx = np.array([[0, 1, -1, 1]], np.int32)
    prof = np.asarray(dispatch._device_profile(None, table, qidx))
    np.testing.assert_array_equal(prof[0], table[[0, 1, 0, 1]])


def test_compile_cache_default_dir(monkeypatch, tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    old = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable(str(tmp_path))
        assert path == str(tmp_path / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    old = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable(str(tmp_path)) is None
    assert jax.config.jax_compilation_cache_dir == old


def test_homologous_pairs_shape():
    from parasail_rs_tpu.utils.workloads import DNA, homologous_pairs

    rng = np.random.default_rng(0)
    pairs = homologous_pairs(rng, 50, 100, 120, DNA, sub_rate=0.02,
                             indel_rate=0.01, flank=10)
    assert len(pairs) == 50
    for q, r in pairs:
        assert 100 <= len(q) <= 120
        assert abs(len(r) - len(q) - 10) <= 12
        assert set(q) <= set(DNA) and set(r) <= set(DNA)
    # homologous: the reference keeps most of the query's letters
    q, r = pairs[0]
    same = sum(a == b for a, b in zip(q, r[5:]))
    assert same > len(q) // 4


def test_chip_smoke_refuses_without_gpu(capsys):
    import chip_smoke as cs

    if jax.default_backend() == "gpu":
        pytest.skip("a GPU is present")
    assert cs.main([]) != 0
    out = capsys.readouterr().out
    assert "ok" not in out and not out.strip().startswith("{")


def test_chip_smoke_phases_dry_run(capsys):
    """Every phase of chip_smoke.py at a tiny size on the CPU: the public
    routes agree with the wavefront and golden."""
    import chip_smoke as cs

    rng = np.random.default_rng(1)
    prot = cs.homologous_pairs(rng, 24, 8, 24, cs.PROTEIN)
    al = cs.phase_score(prot, [0, 7])
    cs.phase_stats(prot, [3])
    reads = cs.homologous_pairs(rng, 12, 20, 20, cs.DNA, sub_rate=0.02,
                                indel_rate=0.05, flank=6)
    cs.phase_cigars(reads, [0, 5])
    cs.phase_stream(al, prot[:20])
    big = cs.homologous_pairs(rng, 8, 10, 20, cs.DNA)
    cs.phase_large_scores(big, [1])
    med = cs.phase_timing(al, prot[:8], "cpu", rounds=1, interpret=True)
    assert set(med) == {"kernel", "wavefront"}
    out = capsys.readouterr().out
    assert "(d) align_cigars" in out and "(g) cpu" in out


def test_chip_smoke_four_phases_dry_run(capsys):
    """The --four phases on four virtual CPU devices."""
    import chip_smoke as cs

    rng = np.random.default_rng(2)
    cs.phase_sharded(cs.homologous_pairs(rng, 20, 8, 24, cs.PROTEIN), 4,
                     interpret=True)
    cs.phase_seqpar(cs.homologous_pairs(rng, 1, 50, 50, cs.DNA)[0], 4)
    out = capsys.readouterr().out
    assert "over 4 devices" in out


def test_chip_smoke_result_line():
    """The contract's last line: platform, kind and count as JAX reports
    them, and nothing else."""
    import chip_smoke as cs

    devs = jax.devices()
    got = json.loads(cs.result_line(devs[:4]))
    assert got == {"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": min(4, len(devs))}}
