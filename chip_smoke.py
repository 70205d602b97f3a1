"""Card smoke test: the engine's main path on one GPU, checked and timed.

Run from the repo root on a machine with an NVIDIA GPU:

    python chip_smoke.py          # phases (a)-(h) on one card
    python chip_smoke.py --four   # sharded_align + seqpar_align on 4 cards

The deployment is local affine-gap Smith-Waterman with BLOSUM62 at
11/1 on 8,192 homologous protein pairs of ~150 residues (BASELINE.json
configs 2-4), beside semi-global stats, CIGAR serving of 150 bp reads
against 160 bp windows, a StreamingAligner and a large-score matrix.
Every phase compares the public entry points with the XLA wavefront
computed on the card and, on a seeded sample, with golden/model.py; a
mismatch raises, and the script exits non-zero.  The last line of
standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

from parasail_rs_tpu.utils.workloads import DNA, PROTEIN, homologous_pairs

ROOT = os.path.dirname(os.path.abspath(__file__))


def card_line() -> str:
    """``name, power limit`` of the first card, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _fields(alns, stats):
    keys = ["score", "end_query", "end_ref", "saturated"]
    cols = {k: [] for k in keys + (["matches", "similar", "length"]
                                   if stats else [])}
    for a in alns:
        cols["score"].append(a.get_score())
        cols["end_query"].append(a.get_end_query())
        cols["end_ref"].append(a.get_end_ref())
        cols["saturated"].append(a.is_saturated())
        if stats:
            cols["matches"].append(a.get_matches())
            cols["similar"].append(a.get_similar())
            cols["length"].append(a.get_length())
    return {k: np.asarray(v, np.int64) for k, v in cols.items()}


def wavefront_out(al, qs, rs, outputs):
    """The XLA wavefront's result for the aligner's batch, on the card."""
    from parasail_rs_tpu.engine import dispatch

    batch, _, _ = al._pack(list(qs), list(rs))
    out = dispatch._wavefront_exec(
        batch, gap_open=al.gap_open, gap_extend=al.gap_extend,
        mode=al.key.mode, free=al.key.free, outputs=outputs,
        width={"64": "32"}.get(al.key.width, al.key.width))
    return {k: np.asarray(v) for k, v in out.items()}


def check_batch(al, pairs, alns, sample, label):
    """Every pair against the wavefront on the card; ``sample`` pairs
    against golden/model.py.  Raises on the first mismatch."""
    from parasail_rs_tpu.golden import model as golden

    stats = al.key.uses_stats
    qs, rs = zip(*pairs)
    got = _fields(alns, stats)
    wf = wavefront_out(al, qs, rs, "stats" if stats else "score")
    for k, v in got.items():
        bad = np.flatnonzero(v != np.asarray(wf[k], np.int64))
        if bad.size:
            raise AssertionError(
                f"{label}: {k} differs from the wavefront at {bad.size} "
                f"pairs, first {int(bad[0])}")
    for b in sample:
        q, r = pairs[b]
        g = golden.align_seqs(q, r, al.matrix, al.gap_open, al.gap_extend,
                              al.key.mode, al.key.free)
        want = [g.score, g.end_query, g.end_ref]
        have = [got["score"][b], got["end_query"][b], got["end_ref"][b]]
        if stats:
            want += [g.matches, g.similar, g.length]
            have += [got["matches"][b], got["similar"][b],
                     got["length"][b]]
        if [int(x) for x in have] != [int(x) for x in want]:
            raise AssertionError(f"{label}: pair {b} {have} != golden {want}")
    print(f"{label}: {len(pairs)} pairs equal the wavefront, "
          f"{len(sample)} equal golden", flush=True)


def route_of(al, pairs):
    """The route the engine picks for this aligner and batch shape."""
    from parasail_rs_tpu.engine import dispatch
    from parasail_rs_tpu.utils.shapes import length_bucket

    qp = length_bucket(max(len(q) for q, _ in pairs))
    rp = length_bucket(max(len(r) for _, r in pairs))
    return dispatch.choose_route(al.key.outputs, qp, rp)[0]


def _sample(rng, n, k):
    return sorted(rng.choice(n, size=min(k, n), replace=False).tolist())


def phase_score(pairs, sample, interpret=False):
    """(b) local SW score with BLOSUM62 11/1 through align_batch."""
    from parasail_rs_tpu import Aligner, Matrix
    from parasail_rs_tpu.engine import dispatch

    al = (Aligner.new().matrix(Matrix.from_name("blosum62")).gap_open(11)
          .gap_extend(1).local().build())
    qs, rs = zip(*pairs)
    alns = al.align_batch(list(qs), list(rs))
    route = route_of(al, pairs)
    print(f"(b) score batch of {len(pairs)} pairs served by the {route} "
          "route", flush=True)
    check_batch(al, pairs, alns, sample, "(b) sw score")
    if route == "kernel":
        batch, _, _ = al._pack(list(qs), list(rs))
        fn, args = dispatch.kernel_step(
            batch, gap_open=11, gap_extend=1, mode="sw", free=al.key.free,
            width=al.key.width, outputs="score", interpret=interpret)
        print("(b) kernel step memory:",
              fn.lower(*args).compile().memory_analysis(), flush=True)
    return al


def phase_stats(pairs, sample):
    """(c) semi-global stats at open > ext and at open <= ext."""
    from parasail_rs_tpu import Aligner, Matrix

    m = Matrix.from_name("blosum62")
    qs, rs = zip(*pairs)
    for open_, ext in ((11, 1), (1, 2)):
        al = (Aligner.new().matrix(m).gap_open(open_).gap_extend(ext)
              .semi_global().use_stats().build())
        alns = al.align_batch(list(qs), list(rs))
        check_batch(al, pairs, alns, sample,
                    f"(c) sg stats {open_}/{ext} ({route_of(al, pairs)})")


def phase_cigars(pairs, sample):
    """(d) align_cigars on reads against windows: every CIGAR against
    the wavefront's trace plane walked on the host, a sample against
    golden walk_trace."""
    from parasail_rs_tpu import Aligner, Matrix
    from parasail_rs_tpu.engine import dispatch
    from parasail_rs_tpu.golden import model as golden

    m = Matrix.create(DNA, 2, -3)
    build = lambda: (Aligner.new().matrix(m).gap_open(5).gap_extend(2)
                     .semi_global())
    al = build().build()
    qs, rs = (list(x) for x in zip(*pairs))
    alns, cigs = al.align_cigars(qs, rs)
    tr = build().use_trace().build()
    batch, ql, rl = tr._pack(qs, rs)
    plane = dispatch._wavefront_exec(
        batch, gap_open=5, gap_extend=2, mode="sg", free=tr.key.free,
        outputs="trace", width="sat")
    talns = tr._alignments_from({k: np.asarray(v) for k, v in plane.items()},
                                ql, rl)
    want = tr.cigars(talns, qs, rs)
    bad = [b for b in range(len(pairs)) if cigs[b] != want[b]]
    if bad:
        raise AssertionError(f"(d) {len(bad)} CIGARs differ from the "
                             f"wavefront walk, first pair {bad[0]}")
    for b in sample:
        q, r = pairs[b]
        g = golden.align_seqs(q, r, m, 5, 2, "sg", al.key.free)
        w = golden.walk_trace(g.trace_table, q, r, g.end_query, g.end_ref,
                              "sg", al.key.free)
        if cigs[b] != w.cigar_string() or alns[b].get_score() != g.score:
            raise AssertionError(f"(d) pair {b} differs from golden")
    print(f"(d) align_cigars ({route_of(tr, pairs)}): {len(pairs)} CIGARs "
          f"equal the wavefront walk, {len(sample)} equal golden",
          flush=True)


def phase_stream(al, pairs):
    """(e) StreamingAligner results equal align_many on the same pairs."""
    from parasail_rs_tpu.engine.stream import StreamingAligner

    qs, rs = (list(x) for x in zip(*pairs))
    want = _fields(al.align_many(qs, rs), False)
    with StreamingAligner(al, flush_size=1024) as stream:
        handles = [stream.submit(q, r) for q, r in pairs]
        stream.flush()
        got = _fields([h.result() for h in handles], False)
    for k in want:
        if not np.array_equal(want[k], got[k]):
            raise AssertionError(f"(e) stream {k} differs from align_many")
    print(f"(e) StreamingAligner: {len(pairs)} submissions equal "
          "align_many", flush=True)


def phase_large_scores(pairs, sample):
    """(f) entries beyond +/-2048: score and stats equal golden, so no
    float32 matmul may round them on the card."""
    from parasail_rs_tpu import Aligner, Matrix

    m = Matrix.create(DNA, 3000, -2500)
    qs, rs = (list(x) for x in zip(*pairs))
    for mode, stats in (("local", False), ("semi_global", True)):
        b = getattr(Aligner.new().matrix(m).gap_open(4000)
                    .gap_extend(700), mode)()
        al = (b.use_stats() if stats else b).build()
        check_batch(al, pairs, al.align_batch(qs, rs), sample,
                    f"(f) {al.key.mode} {'stats' if stats else 'score'} "
                    f"3000/-2500 ({route_of(al, pairs)})")


def phase_timing(al, pairs, card, rounds=5, interpret=False):
    """(g) the kernel route against the XLA wavefront route, end to end
    (pack, device, fetch, result objects) at the batch's full size, in
    turns, warm-up outside the window."""
    import jax

    from parasail_rs_tpu.engine import dispatch

    qs, rs = (list(x) for x in zip(*pairs))
    kw = dict(gap_open=al.gap_open, gap_extend=al.gap_extend,
              mode=al.key.mode, free=al.key.free,
              width={"64": "32"}.get(al.key.width, al.key.width))

    def leg(route):
        batch, ql, rl = al._pack(qs, rs)
        if route == "kernel":
            out = dispatch._execute_kernel(batch, outputs="score",
                                           interpret=interpret, **kw)
        else:
            out = dispatch._wavefront_exec(batch, outputs="score", **kw)
            out = {k: np.asarray(jax.block_until_ready(v))
                   for k, v in out.items()}
        return al._alignments_from(out, ql, rl)

    times = {"kernel": [], "wavefront": []}
    first = {r: _fields(leg(r), False) for r in times}    # warm-up
    for k in first["kernel"]:
        if not np.array_equal(first["kernel"][k], first["wavefront"][k]):
            raise AssertionError(f"(g) {k} differs between the legs")
    for i in range(rounds):
        order = ("kernel", "wavefront") if i % 2 == 0 else \
            ("wavefront", "kernel")
        for r in order:
            t = time.perf_counter()
            leg(r)
            times[r].append(time.perf_counter() - t)
    med = {r: float(np.median(v)) for r, v in times.items()}
    print(f"(g) {card}: {len(pairs)} pairs local score end to end, median "
          f"of {rounds}: kernel {med['kernel'] * 1e3:.3f} ms, XLA "
          f"wavefront {med['wavefront'] * 1e3:.3f} ms "
          f"({med['wavefront'] / med['kernel']:.2f}x)", flush=True)
    return med


def phase_sharded(pairs, n_dev, interpret=False):
    """--four: sharded_align over a 1-D mesh of ``n_dev`` devices, bit-
    equal to one device's Aligner result, with every shard on its own
    device."""
    import jax

    from parasail_rs_tpu import Aligner, Matrix
    from parasail_rs_tpu.dist import make_device_mesh, sharded_align
    from parasail_rs_tpu.dist.sharded import gather_scores
    from parasail_rs_tpu.engine import dispatch

    m = Matrix.from_name("blosum62")
    al = (Aligner.new().matrix(m).gap_open(11).gap_extend(1).local()
          .build())
    qs, rs = (list(x) for x in zip(*pairs))
    one = _fields(al.align_batch(qs, rs), False)
    batch, _, _ = al._pack(qs, rs)
    prof = np.asarray(dispatch._device_profile(None, batch.table,
                                               batch.qidx))
    mesh = make_device_mesh(n_dev)
    t = time.perf_counter()
    out = sharded_align(
        mesh, prof, np.asarray(batch.qidx), np.asarray(batch.ridx),
        batch.qlen, batch.rlen, open_=11, ext=1, mode="sw",
        free=al.key.free, outputs="score", width=al.key.width,
        interpret=interpret)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t
    devs = {s.device for s in out["score"].addressable_shards}
    if len(devs) != n_dev:
        raise AssertionError(f"sharded output lives on {len(devs)} devices")
    host = gather_scores(out)
    for k in ("score", "end_query", "end_ref"):
        if not np.array_equal(np.asarray(host[k], np.int64), one[k]):
            raise AssertionError(f"sharded {k} differs from one device")
    print(f"sharded_align: {len(pairs)} pairs over {n_dev} devices "
          f"({sorted(str(d) for d in devs)}) equal one device "
          f"(first call {dt:.3f} s)", flush=True)


def phase_seqpar(pair, n_dev):
    """--four: seqpar_align on one long pair equals the single-device
    wavefront score."""
    from parasail_rs_tpu import Matrix
    from parasail_rs_tpu.dist import make_device_mesh, seqpar_align
    from parasail_rs_tpu.engine.profile import profile_rows
    from parasail_rs_tpu.ops.wavefront import wavefront_align

    m = Matrix.create(DNA, 2, -3)
    q, r = pair
    q_chunk = 256 if len(q) > 1024 else 16
    Qp = -(-len(q) // q_chunk) * q_chunk
    Rp = -(-len(r) // (n_dev * 8)) * (n_dev * 8)
    qi, ri = m.encode(q), m.encode(r)
    prof = np.zeros((Qp, m.size, 1), np.int32)
    prof[:len(q), :, 0] = profile_rows(m, qi)
    ridx = np.zeros((Rp, 1), np.int32)
    ridx[:len(r), 0] = ri
    qlen = np.array([len(q)], np.int32)
    rlen = np.array([len(r)], np.int32)
    sp = seqpar_align(prof, ridx, qlen, rlen, open_=5, ext=2,
                      mesh=make_device_mesh(n_dev), mode="sw",
                      free=(True,) * 4, q_chunk=q_chunk)
    qidx = np.full((1, Qp), -1, np.int32)
    qidx[0, :len(q)] = qi
    wf = wavefront_align(prof.transpose(2, 0, 1), qidx, ridx.T, qlen, rlen,
                         open_=np.int32(5), ext=np.int32(2), mode="sw",
                         free=(True,) * 4, outputs="score", width="32")
    got, want = int(sp["score"][0]), int(wf["score"][0])
    if got != want:
        raise AssertionError(f"seqpar score {got} != wavefront {want}")
    print(f"seqpar_align: one {len(q)} x {len(r)} pair over {n_dev} "
          f"devices scores {got}, equal to one device's wavefront",
          flush=True)


def result_line(devs) -> str:
    """The last line of a passing run: the device as JAX reports it."""
    return json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded and "
                         "sequence-parallel phases")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax

    # (a) device check
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 2
    from parasail_rs_tpu.utils import compile_cache

    compile_cache.enable(ROOT)
    card = card_line()
    print(card, flush=True)
    print(f"(a) JAX sees {len(jax.devices())} x {dev.device_kind}",
          flush=True)
    rng = np.random.default_rng(args.seed)
    if args.four:
        n = len(jax.devices())
        if n != 4 or any(d.platform != "gpu" for d in jax.devices()):
            print(f"chip_smoke --four: needs 4 GPUs, JAX sees {n}",
                  file=sys.stderr)
            return 2
        phase_sharded(homologous_pairs(rng, 4 * 8192, 140, 160, PROTEIN), 4)
        phase_seqpar(homologous_pairs(rng, 1, 16000, 16000, DNA)[0], 4)
    else:
        prot = homologous_pairs(rng, 8192, 140, 160, PROTEIN)
        sample = _sample(rng, len(prot), 256)
        al = phase_score(prot, sample)
        phase_stats(prot, sample)
        reads = homologous_pairs(rng, 4096, 150, 150, DNA, sub_rate=0.02,
                                 indel_rate=0.005, flank=10)
        phase_cigars(reads, _sample(rng, len(reads), 256))
        phase_stream(al, prot[:3000])
        big = homologous_pairs(rng, 1024, 140, 160, DNA)
        phase_large_scores(big, _sample(rng, len(big), 256))
        phase_timing(al, prot, card)
    print(result_line(jax.devices()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
