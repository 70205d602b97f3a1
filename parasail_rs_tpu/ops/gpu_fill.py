"""Pallas (Triton) DP fill for short pairs: one pair per GPU thread.

The GPU designs for batches of many short pairs (inter-task CUDASW++,
GASAL2, AnySeq/GPU) give each thread one pair and sweep its DP matrix
with the state in registers.  This kernel follows that mapping:

- one program owns ``PB`` pairs, one per lane (``PB = 32 * num_warps``,
  so every thread holds exactly one pair);
- the query is cut into strips of ``QS`` rows.  A strip's rows are
  unrolled in the program and sweep the reference columns in a skewed
  wavefront (row ``i`` of the strip works on column ``t - i`` in loop
  step ``t``), so the ``QS`` cells of one step are independent and
  their H/E/F state stays in registers;
- the strip's last row hands its H/E (and stats) column to the next
  strip through a per-lane boundary buffer in device memory, written and
  read by the same thread;
- substitution scores are gathered from the letter-indexed profile
  (``sub[qoff[i] + ridx[j]]``): the (A, A) table, or PSSM rows, never a
  per-cell tensor.

Each cell runs golden's Gotoh recurrence exactly, comparisons and tie
rules included (golden/model.py), so score, end coordinates, saturation
flags, stats and trace flags are bit-identical for every penalty pair.
Stats ride as one packed int32 per matrix, ``[matches | similar |
length]``, whose fields never carry into each other while the pair's
span fits (:func:`stats_fields`).

``interpret=True`` runs the same kernel through the Pallas interpreter;
only tests pass it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..constants import (
    NEG_INF32,
    TRACE_DEL,
    TRACE_DEL_F,
    TRACE_DIAG,
    TRACE_DIAG_E,
    TRACE_DIAG_F,
    TRACE_INS,
    TRACE_INS_E,
    WIDTH_MAX,
    WIDTH_MIN,
)

I32 = jnp.int32
OUTPUTS = ("score", "stats", "trace")
MAX_QP = 256


def scalar_names(width: str, stats: bool) -> tuple[str, ...]:
    """Per-pair scalar rows of the packed result, sorted by name."""
    names = {"saturated", "score", "end_query", "end_ref"}
    if width == "sat":
        names.add("promoted")
    if stats:
        names.update({"matches", "similar", "length"})
    return tuple(sorted(names))


def stats_fields(qp: int, rp: int):
    """(SH_M, SH_S) shifts of the packed ``[m | s | l]`` stats word, or
    None when the fields cannot fit 31 bits.  m and s count diagonal
    steps (<= qp); l counts alignment columns (<= qp + rp)."""
    bm = max(1, qp.bit_length())
    bl = max(1, (qp + rp).bit_length())
    if 2 * bm + bl > 31:
        return None
    return bm + bl, bl


def supports(outputs: str, qp: int, rp: int, banded: bool = False) -> bool:
    """Can the kernel serve this output class and padded shape?"""
    if banded or outputs not in OUTPUTS or qp > MAX_QP or qp % 8:
        return False
    return outputs != "stats" or stats_fields(qp, rp) is not None


def block_config(qp: int, outputs: str):
    """(QS rows per strip, PB pairs per program, num_warps)."""
    qs = 16 if (outputs == "score" and qp % 16 == 0) else 8
    return qs, 32, 1


def _make_kernel(Qp, Rp, QS, PB, mode, free, outputs, width, fields):
    local = mode == "sw"
    qb, qe, db, de = (True,) * 4 if local else free
    stats = outputs == "stats"
    trace = outputs == "trace"
    detect = width in ("8", "16", "sat")
    names = scalar_names(width, stats)
    SHM, SHS = fields if stats else (0, 0)
    neg = NEG_INF32
    nstrip = Qp // QS

    def kernel(gaps_ref, sub_ref, qoff_ref, qidx_ref, ridx_ref, qlen_ref,
               rlen_ref, out_ref, bnd_ref, *trace_ref):
        b0 = pl.program_id(0) * PB
        lanes = pl.ds(b0, PB)
        open_ = gaps_ref[0]
        ext = gaps_ref[1]
        qlen = qlen_ref[lanes]
        rlen = rlen_ref[lanes]
        zero = jnp.zeros((PB,), I32)
        negv = jnp.full((PB,), neg, I32)
        lanewise = lambda b: jnp.broadcast_to(b, (PB,))   # scalar -> mask

        def border(c, free_end):
            # bordered H at c consumed characters along one edge
            if free_end or local:
                return zero
            return jnp.where(c > 0, -(open_ + (c - 1) * ext), 0) + zero

        def border_len(c, free_end):
            return zero if (free_end or local) else c + zero

        def strip(si, glob):
            r0 = si * QS
            rows = [r0 + i for i in range(QS)]
            qoff = [qoff_ref[g, lanes] for g in rows]
            qidx = [qidx_ref[g, lanes] for g in rows] if stats else None
            live = [g < qlen for g in rows]
            last = [g == qlen - 1 for g in rows]
            first = r0 == 0

            def col(t, c):
                (hc, ec, fc, hd, let, bv, bj, hx, hn,
                 pc, pe, pf, pd, bp) = c
                # row 0 of the strip: the column above comes from the
                # previous strip's boundary (or the top border)
                j0 = t
                inb = (j0 >= 0) & (j0 < Rp)
                jc = jnp.clip(j0, 0, Rp - 1)
                ld = lambda k, other: plgpu.load(
                    bnd_ref.at[k, jc, lanes], mask=lanewise(inb & ~first),
                    other=other)
                up_h0 = jnp.where(first, border(j0 + 1, qb), ld(0, neg))
                up_e0 = jnp.where(first, negv, ld(1, neg))
                if stats:
                    up_p0 = jnp.where(first, border_len(j0 + 1, qb),
                                      ld(2, 0))
                    up_pe0 = jnp.where(first, zero, ld(3, 0))
                r_new = plgpu.load(ridx_ref.at[jc, lanes],
                                   mask=lanewise(inb), other=0)
                let_n = (r_new,) + let[:-1]
                n_hc, n_ec, n_fc, n_hd = [], [], [], []
                n_bv, n_bj, n_hx, n_hn = [], [], [], []
                n_pc, n_pe, n_pf, n_pd, n_bp = [], [], [], [], []
                for i in range(QS):
                    g = rows[i]
                    j = t - i
                    if i == 0:
                        up_h, up_e = up_h0, up_e0
                        dg = hd[0]
                    else:
                        up_h, up_e = hc[i - 1], ec[i - 1]
                        dg = hd[i]
                    j_is0 = j == 0
                    dg = jnp.where(j_is0, border(g, db), dg)
                    left_h = jnp.where(j_is0, border(g + 1, db), hc[i])
                    left_f = jnp.where(j_is0, negv, fc[i])
                    e_open = up_h - open_
                    e_ext = up_e - ext
                    E = jnp.maximum(e_open, e_ext)
                    oe = e_open >= e_ext
                    f_open = left_h - open_
                    f_ext = left_f - ext
                    F = jnp.maximum(f_open, f_ext)
                    of = f_open >= f_ext
                    s = sub_ref[qoff[i] + let_n[i]]
                    diag = dg + s
                    H = jnp.maximum(diag, jnp.maximum(E, F))
                    tdiag = (diag >= E) & (diag >= F)
                    te = ~tdiag & (E >= F)
                    if local:
                        clamp = H <= 0
                        H = jnp.maximum(H, 0)
                    cell = live[i] & (j >= 0) & (j < rlen)
                    if local:
                        cand = cell
                    else:
                        endc = j == rlen - 1
                        sel = last[i] & endc
                        if mode == "sg":
                            if qe:
                                sel = sel | last[i]
                            if de:
                                sel = sel | endc
                        cand = cell & sel
                    better = cand & (H > bv[i])
                    n_bv.append(jnp.where(better, H, bv[i]))
                    n_bj.append(jnp.where(better, j, bj[i]))
                    if detect and not local:
                        n_hx.append(jnp.where(cell, jnp.maximum(hx[i], H),
                                              hx[i]))
                        n_hn.append(jnp.where(cell, jnp.minimum(hn[i], H),
                                              hn[i]))
                    if stats:
                        if i == 0:
                            up_p, up_pe = up_p0, up_pe0
                        else:
                            up_p, up_pe = pc[i - 1], pe[i - 1]
                        pdg = jnp.where(j_is0, border_len(g, db), pd[i])
                        left_p = jnp.where(j_is0, border_len(g + 1, db),
                                           pc[i])
                        left_pf = jnp.where(j_is0, zero, pf[i])
                        PE = jnp.where(oe, up_p, up_pe) + 1
                        PF = jnp.where(of, left_p, left_pf) + 1
                        inc = (((qidx[i] == let_n[i]).astype(I32) << SHM)
                               + ((s > 0).astype(I32) << SHS) + 1)
                        PH = jnp.where(tdiag, pdg + inc,
                                       jnp.where(te, PE, PF))
                        if local:
                            PH = jnp.where(clamp, 0, PH)
                        n_pc.append(PH)
                        n_pe.append(PE)
                        n_pf.append(PF)
                        n_pd.append(up_p)
                        n_bp.append(jnp.where(better, PH, bp[i]))
                    if trace:
                        hflag = jnp.where(tdiag, TRACE_DIAG,
                                          jnp.where(te, TRACE_INS,
                                                    TRACE_DEL))
                        if local:
                            hflag = jnp.where(clamp, 0, hflag)
                        flag = (hflag | jnp.where(oe, TRACE_DIAG_E,
                                                  TRACE_INS_E)
                                | jnp.where(of, TRACE_DIAG_F, TRACE_DEL_F))
                        jin = (j >= 0) & (j < Rp)
                        plgpu.store(
                            trace_ref[0].at[g, jnp.clip(j, 0, Rp - 1),
                                            lanes],
                            flag.astype(jnp.int8), mask=lanewise(jin))
                    n_hc.append(H)
                    n_ec.append(E)
                    n_fc.append(F)
                    n_hd.append(up_h)
                # the strip's last row hands its column down
                jl = t - (QS - 1)
                jin = (jl >= 0) & (jl < Rp)
                jlc = jnp.clip(jl, 0, Rp - 1)
                m = lanewise(jin)
                plgpu.store(bnd_ref.at[0, jlc, lanes], n_hc[-1], mask=m)
                plgpu.store(bnd_ref.at[1, jlc, lanes], n_ec[-1], mask=m)
                if stats:
                    plgpu.store(bnd_ref.at[2, jlc, lanes], n_pc[-1], mask=m)
                    plgpu.store(bnd_ref.at[3, jlc, lanes], n_pe[-1], mask=m)
                return (tuple(n_hc), tuple(n_ec), tuple(n_fc), tuple(n_hd),
                        let_n, tuple(n_bv), tuple(n_bj),
                        tuple(n_hx) or hx, tuple(n_hn) or hn,
                        tuple(n_pc) or pc, tuple(n_pe) or pe,
                        tuple(n_pf) or pf, tuple(n_pd) or pd,
                        tuple(n_bp) or bp)

            rowv = lambda v: (v,) * QS
            none = ()
            c0 = (rowv(negv), rowv(negv), rowv(negv), rowv(zero),
                  rowv(zero), rowv(zero if local else negv), rowv(zero),
                  rowv(negv) if detect and not local else none,
                  rowv(-negv) if detect and not local else none,
                  *((rowv(zero),) * 4 if stats else (none,) * 4),
                  rowv(zero) if stats else none)
            c = jax.lax.fori_loop(0, Rp + QS - 1, col, c0)
            _, _, _, _, _, bv, bj, hx, hn, _, _, _, _, bp = c
            gv, gi, gj, ghx, ghn, gp = glob
            for i in range(QS):
                better = bv[i] > gv
                gv = jnp.where(better, bv[i], gv)
                gi = jnp.where(better, rows[i], gi)
                gj = jnp.where(better, bj[i], gj)
                if stats:
                    gp = jnp.where(better, bp[i], gp)
                if detect and not local:
                    ghx = jnp.maximum(ghx, hx[i])
                    ghn = jnp.minimum(ghn, hn[i])
            return gv, gi, gj, ghx, ghn, gp

        # no candidate cell (empty sequences) leaves the wavefront's
        # sentinels: score NEG at (Qp, Rp), or an empty local alignment
        g0 = ((zero, zero, zero) if local else (negv, zero + Qp, zero + Rp)) \
            + (negv, -negv, zero)
        gv, gi, gj, ghx, ghn, gp = jax.lax.fori_loop(0, nstrip, strip, g0)
        if local:
            ghx, ghn = gv, zero
        res = {"score": gv, "end_query": gi, "end_ref": gj}
        if mode == "nw":
            res["end_query"] = qlen - 1
            res["end_ref"] = rlen - 1

        def hit(w):
            return ((ghx >= WIDTH_MAX[w]) | (ghn <= WIDTH_MIN[w])).astype(I32)

        res["saturated"] = {"8": hit("8"), "16": hit("16"),
                            "sat": hit("16")}.get(width, zero)
        if width == "sat":
            res["promoted"] = hit("8")
        if stats:
            res["matches"] = gp >> SHM
            res["similar"] = (gp >> SHS) & ((1 << (SHM - SHS)) - 1)
            res["length"] = gp & ((1 << SHS) - 1)
        for k, name in enumerate(names):
            out_ref[k, lanes] = res[name]

    return kernel


@functools.partial(jax.jit, static_argnames=(
    "mode", "free", "outputs", "width", "block", "interpret"))
def dp_fill(sub, qoff, qidx, ridx, qlen, rlen, gaps, *, mode, free,
            outputs, width, block=None, interpret=False):
    """Run the kernel over a batch.

    sub:   flat int32 substitution values (the (A, A) table or profile)
    qoff:  (Bq, Qp) int32 offset of each query row's scores in ``sub``
           (Bq is 1 for a query shared by the batch, else B)
    qidx:  (Bq, Qp) int32 mapped query letters, -1 on padded rows
    ridx:  (B, Rp) int32 mapped reference letters
    qlen, rlen: (B,) int32; gaps: (2,) int32 [open, ext]

    Returns ``(packed, big)``: packed is (len(scalar_names), B) int32 in
    :func:`scalar_names` order; big holds ``trace_table`` (B, Qp, Rp)
    int8 for the trace class.
    """
    B, Rp = ridx.shape
    Qp = qoff.shape[1]
    QS, PB, nw = block or block_config(Qp, outputs)
    fields = stats_fields(Qp, Rp) if outputs == "stats" else None
    Bp = -(-B // PB) * PB

    def lanes(x, fill):
        # (Bq or B, N) -> (N, Bp): pairs on the minor axis
        x = jnp.broadcast_to(x, (B,) + x.shape[1:]).astype(I32)
        return jnp.pad(x, ((0, Bp - B), (0, 0)), constant_values=fill).T

    names = scalar_names(width, outputs == "stats")
    out_shape = [jax.ShapeDtypeStruct((len(names), Bp), I32),
                 jax.ShapeDtypeStruct(
                     (4 if outputs == "stats" else 2, Rp, Bp), I32)]
    if outputs == "trace":
        out_shape.append(jax.ShapeDtypeStruct((Qp, Rp, Bp), jnp.int8))
    kernel = _make_kernel(Qp, Rp, QS, PB, mode, free, outputs, width,
                          fields)
    outs = pl.pallas_call(
        kernel,
        out_shape=out_shape,
        grid=(Bp // PB,),
        compiler_params=plgpu.CompilerParams(num_warps=nw, num_stages=1),
        backend="triton",
        interpret=interpret,
        name=f"dp_fill_{mode}_{outputs}",
    )(jnp.asarray(gaps, I32), sub.astype(I32).reshape(-1),
      lanes(qoff, 0), lanes(qidx, -1), lanes(ridx, 0),
      jnp.pad(qlen.astype(I32), (0, Bp - B)),
      jnp.pad(rlen.astype(I32), (0, Bp - B)))
    big = {}
    if outputs == "trace":
        big["trace_table"] = outs[2].transpose(2, 0, 1)[:B]
    return outs[0][:, :B], big
