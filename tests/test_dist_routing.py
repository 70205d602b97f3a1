"""Sharded dispatch routes through the same fills as one device.

These tests run both routes of dist.sharded over the 8-virtual-device
CPU mesh (the GPU kernel in interpret mode) and pin: bit-equality with
golden, shared-profile (leading dim 1) replication, internal padding of
odd batch sizes, and the route decision itself.
"""

import numpy as np
import pytest

from parasail_rs_tpu.dist import make_device_mesh
from parasail_rs_tpu.dist.sharded import (
    gather_scores, plan_sharded_route, sharded_align)
from parasail_rs_tpu.engine.dispatch import build_batch
from parasail_rs_tpu.engine.profile import profile_rows
from parasail_rs_tpu.golden import model as golden
from parasail_rs_tpu.matrices import Matrix

MESH = make_device_mesh(8)
ALPHA = list(b"ARNDCQEGHILKMFPSTWYV")


def _pairs(rng, m, B, lo=4, hi=14):
    pairs, prows, qidxs, ridxs = [], [], [], []
    for _ in range(B):
        q = rng.choice(ALPHA, size=rng.integers(lo, hi)).astype(
            "uint8").tobytes()
        r = rng.choice(ALPHA, size=rng.integers(lo, hi)).astype(
            "uint8").tobytes()
        pairs.append((q, r))
        qi, ri = m.encode(q), m.encode(r)
        qidxs.append(qi)
        ridxs.append(ri)
        prows.append(profile_rows(m, qi))
    return pairs, build_batch(prows, qidxs, ridxs)


@pytest.mark.parametrize("outputs", ["score", "stats"])
@pytest.mark.parametrize("route", ["kernel", "wavefront"])
def test_sharded_routes_match_golden(outputs, route):
    m = Matrix.from_name("blosum62")
    rng = np.random.default_rng(11)
    B = 16
    pairs, batch = _pairs(rng, m, B)
    out = sharded_align(
        MESH, batch.profile, batch.qidx, batch.ridx, batch.qlen, batch.rlen,
        open_=10, ext=1, mode="sw", free=(True,) * 4, outputs=outputs,
        width="sat", route=route, interpret=True)
    host = gather_scores(out)
    assert host["score"].shape[0] == B
    for b in range(B):
        g = golden.align_seqs(*pairs[b], m, 10, 1, "sw")
        assert host["score"][b] == g.score, (b, host["score"][b], g.score)
        if outputs == "stats":
            assert host["matches"][b] == g.matches
            assert host["similar"][b] == g.similar
            assert host["length"][b] == g.length


def test_sharded_scan_odd_batch_padded_internally():
    """A batch that divides neither the mesh nor the kernel's lane
    block."""
    m = Matrix.from_name("blosum62")
    rng = np.random.default_rng(13)
    B = 19
    pairs, batch = _pairs(rng, m, B)
    out = sharded_align(
        MESH, batch.profile, batch.qidx, batch.ridx, batch.qlen, batch.rlen,
        open_=10, ext=1, mode="nw", free=(False,) * 4, outputs="score",
        route="kernel", interpret=True)
    host = gather_scores(out)
    assert host["score"].shape[0] == B
    for b in (0, 7, B - 1):
        g = golden.align_seqs(*pairs[b], m, 10, 1, "nw")
        assert host["score"][b] == g.score


def test_sharded_shared_profile_replicated():
    """Profile reuse: (1, Qp, A) profile/qidx must replicate, not shard."""
    m = Matrix.from_name("blosum62")
    rng = np.random.default_rng(17)
    B = 16
    q = rng.choice(ALPHA, size=10).astype("uint8").tobytes()
    qi = m.encode(q)
    refs = [rng.choice(ALPHA, size=rng.integers(4, 14)).astype(
        "uint8").tobytes() for _ in range(B)]
    prows = profile_rows(m, qi)
    Qp, Rp = 16, 16
    profile = np.zeros((1, Qp, m.size), np.int32)
    profile[0, :len(qi)] = prows
    qidx = np.full((1, Qp), -1, np.int32)
    qidx[0, :len(qi)] = qi
    ridx = np.zeros((B, Rp), np.int32)
    rlen = np.zeros(B, np.int32)
    for b, r in enumerate(refs):
        ri = m.encode(r)
        ridx[b, :len(ri)] = ri
        rlen[b] = len(ri)
    qlen = np.full(B, len(qi), np.int32)

    for route in ("kernel", "wavefront"):
        out = sharded_align(
            MESH, profile, qidx, ridx, qlen, rlen,
            open_=10, ext=1, mode="sw", free=(True,) * 4, outputs="score",
            route=route, interpret=True)
        host = gather_scores(out)
        for b in range(B):
            g = golden.align_seqs(q, refs[b], m, 10, 1, "sw")
            assert host["score"][b] == g.score, (route, b)


def test_plan_sharded_route_gates():
    """The sharded route is the engine's own decision."""
    from parasail_rs_tpu.engine.dispatch import choose_route

    for outputs, qp, rp in [("score", 256, 256), ("stats", 192, 16384),
                            ("trace", 64, 64), ("table", 16, 16),
                            ("score", 512, 64)]:
        for platform in ("gpu", "cpu"):
            assert plan_sharded_route(
                outputs=outputs, Qp=qp, Rp=rp, platform=platform) == \
                choose_route(outputs, qp, rp, platform=platform)[0]
    assert plan_sharded_route(outputs="score", Qp=256, Rp=256,
                              platform="gpu") == "kernel"
    assert plan_sharded_route(outputs="score", Qp=256, Rp=256,
                              platform="cpu") == "wavefront"
    assert plan_sharded_route(outputs="stats", Qp=512, Rp=64,
                              platform="gpu") == "wavefront"


@pytest.mark.parametrize("open_,ext,mode", [(1, 3, "sw"), (2, 2, "nw"),
                                            (0, 1, "sg")])
def test_sharded_trace_walk_stats_open_le_ext(open_, ext, mode):
    """Stats at gap_open <= gap_extend on the per-shard kernel under
    shard_map — bit-exact vs golden on the 8-device mesh."""
    m = Matrix.from_name("blosum62")
    rng = np.random.default_rng(29)
    B = 16
    pairs, batch = _pairs(rng, m, B)
    free = golden.free_flags(mode)
    out = sharded_align(
        MESH, batch.profile, batch.qidx, batch.ridx, batch.qlen,
        batch.rlen, open_=open_, ext=ext, mode=mode, free=free,
        outputs="stats", width="sat", route="kernel", interpret=True)
    host = gather_scores(out)
    for b in range(B):
        g = golden.align_seqs(*pairs[b], m, open_, ext, mode)
        assert host["score"][b] == g.score
        assert host["matches"][b] == g.matches
        assert host["similar"][b] == g.similar
        assert host["length"][b] == g.length
        assert host["end_query"][b] == g.end_query
        assert host["end_ref"][b] == g.end_ref
