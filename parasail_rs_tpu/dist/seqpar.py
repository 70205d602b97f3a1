"""Sequence-parallel DP fill: one (huge) pair sharded across chips.

The DP-matrix analog of ring attention (SURVEY.md §5.7): the reference
axis is sharded into contiguous column chunks over the ``seq`` axis of a
device mesh, the query axis is cut into chunks, and the fill proceeds as
a pipelined wavefront over (query-chunk x device) tiles — device d works
on query-chunk t at super-step s = t + d.  Two state flows:

- rightward (device -> right neighbor, ``lax.ppermute``): the
  final (H, F) column of the device's chunk for the current query-chunk
  rows, plus the above-row diagonal cell — the halo the neighbor's first
  column consumes;
- downward (device-local): per column, the last-row H and the running
  prefix-max PM[j] = max_{k<r0} (Htemp[k,j] - open + e_ext*k) with
  e_ext = min(open, ext), which seeds the vertical-gap prefix scan of
  the next query-chunk.  Golden's E recurrence unrolls exactly to that
  prefix form with slope min(open, ext), so value outputs are exact for
  any penalties; stats need strict gap_open > gap_extend.

The reference's closest feature is the scalar banded NW offered for
"large sequences" (src/aligner/mod.rs:454-489); there is no distributed
analog to port — this is the designed-fresh long-sequence story.

Substitution scores are gathered per tile from the profile (no global
substitution tensor is ever materialized), so memory per device is
O(Qp + C·Qc), independent of the full Qp x Rp problem.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..constants import (
    NEG_INF32,
    TRACE_DEL,
    TRACE_DEL_F,
    TRACE_DIAG,
    TRACE_DIAG_E,
    TRACE_DIAG_F,
    TRACE_INS,
    TRACE_INS_E,
)

I32 = jnp.int32


def _shard_map(fn, mesh, in_specs, out_specs):
    try:
        return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False)
    except (AttributeError, TypeError):
        from jax.experimental.shard_map import shard_map

        return shard_map(fn, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_rep=False)


def _prefix_max_exclusive(a, ii, seed):
    neg = NEG_INF32
    x = jnp.where(ii == 0, seed, jnp.roll(a, 1, axis=0))
    s = 1
    while s < a.shape[0]:
        x = jnp.maximum(x, jnp.where(ii >= s, jnp.roll(x, s, axis=0), neg))
        s *= 2
    return x


def _prefix_argmax_exclusive(a, payloads, ii, seed, seed_payloads):
    """Payload-carrying exclusive prefix max; ties prefer the larger
    origin row, matching the golden oracle."""
    neg = NEG_INF32
    x = jnp.where(ii == 0, seed, jnp.roll(a, 1, axis=0))
    ps = [jnp.where(ii == 0, sp, jnp.roll(p, 1, axis=0))
          for p, sp in zip(payloads, seed_payloads)]
    s = 1
    while s < a.shape[0]:
        xs = jnp.where(ii >= s, jnp.roll(x, s, axis=0), neg)
        take = xs > x
        x = jnp.where(take, xs, x)
        ps = [jnp.where(take, jnp.roll(p, s, axis=0), p) for p in ps]
        s *= 2
    return x, ps


def seqpar_align(*args, **kw):
    """Public entry: validates the gap contract eagerly (the jitted body
    sees traced penalties), then dispatches :func:`_seqpar_align_jit`.
    See its docstring for the full contract."""
    open_ = kw.get("open_", None)
    ext = kw.get("ext", None)
    outputs = kw.get("outputs", "score")
    if open_ is not None and ext is not None:
        if outputs == "stats" and int(open_) <= int(ext):
            # the prefix-scan payloads cannot follow golden's gap
            # restart ties at open <= ext; silently wrong accumulators
            # are worse than an error (single-chip configs are exact)
            raise ValueError(
                f"sequence-parallel stats require gap_open > gap_extend "
                f"(payload tie semantics); got {int(open_)}/{int(ext)}")
    return _seqpar_align_jit(*args, **kw)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "mode", "free", "q_chunk", "outputs"),
)
def _seqpar_align_jit(
    profile,      # (Qp, A, B) int32 — query profile rows, replicated
    ridx,         # (Rp, B) int32 — reference indices, sharded over "seq"
    qlen,         # (B,) int32
    rlen,         # (B,) int32
    qidx=None,    # (Qp, B) int32 — required for outputs="stats"
    *,
    open_,
    ext,
    mesh: Mesh,
    mode: str,
    free: tuple[bool, bool, bool, bool] = (False,) * 4,
    q_chunk: int = 256,
    outputs: str = "score",
):
    """Score (+ stats/trace) and end coordinates for pairs too long for
    one chip.

    Rp must divide by the mesh size; Qp by ``q_chunk``.  Returns
    {score, end_query, end_ref} (B,) int32 — plus matches/similar/length
    for ``outputs="stats"`` (which requires gap_open > gap_extend, the
    same payload-prefix contract as the single-chip kernel) — bit-exact
    vs the golden oracle.

    ``outputs="trace"`` additionally emits ``trace_table`` (B, Qp, Rp)
    int8 flags, column-sharded over the mesh: each device materializes
    only its own (Qp, Rp/D) shard during the fill, so a multi-chip-sized
    pair's flag plane never exists on one chip; the host walk (native
    walker / golden) consumes the gathered plane to produce CIGARs.
    """
    want_stats = outputs == "stats"
    want_trace = outputs == "trace"
    if qidx is None:
        assert not want_stats, "stats need the mapped query indices"
        qidx = jnp.zeros((profile.shape[0], profile.shape[2]), I32)
    Qp, A, B = profile.shape
    Rp = ridx.shape[0]
    D = mesh.devices.size
    assert Rp % D == 0 and Qp % q_chunk == 0
    C = Rp // D
    S = Qp // q_chunk
    Qc = q_chunk
    axis = mesh.axis_names[0]
    local = mode == "sw"
    qb, qe, db, de = (True,) * 4 if local else free
    neg = NEG_INF32
    open_ = jnp.asarray(open_, I32)
    ext = jnp.asarray(ext, I32)
    # vertical prefix-scan slope — min(open, ext) is the exact closed
    # form of golden's E recurrence for any penalties: when open < ext,
    # re-opening a length-1 gap through H beats extending at every step
    e_ext = jnp.minimum(ext, open_)

    def top_b(jg):  # bordered H[0][jg]
        v = jnp.where(jg > 0, -(open_ + (jg - 1) * ext), 0).astype(I32)
        return jnp.zeros_like(v) if qb or local else v

    def left_b(ig):  # bordered H[ig][0]
        v = jnp.where(ig > 0, -(open_ + (ig - 1) * ext), 0).astype(I32)
        return jnp.zeros_like(v) if db or local else v

    def device_fn(profile, ridx_sh, qlen, rlen, qidx):
        # ridx_sh: (C, B) — this device's column chunk.
        d = jax.lax.axis_index(axis)
        jg0 = d * C                                   # first global column
        iic = jax.lax.broadcasted_iota(I32, (Qc, B), 0)
        nstat = 9 if want_stats else 0

        def top_len(c):
            return (jnp.zeros_like(jnp.asarray(c), I32)
                    if (qb or local) else jnp.asarray(c, I32))

        def left_len(c):
            return (jnp.zeros_like(jnp.asarray(c), I32)
                    if (db or local) else jnp.asarray(c, I32))

        def superstep(carry, s):
            (dHlast, dPM, dstats, halo_h, halo_f, halo_sc, halo_top,
             best, bi, bj, bstats, dEdown, tbuf) = carry
            t = s - d
            active = (t >= 0) & (t < S)
            tc = jnp.clip(t, 0, S - 1)
            r0 = tc * Qc                              # first global row
            prof_c = jax.lax.dynamic_slice(
                profile, (r0, 0, 0), (Qc, A, B))
            # (C, Qc, B) substitution tile: an exact integer gather of
            # prof_c[q, ridx[c, b], b]
            stile = jnp.take_along_axis(
                prof_c[None], ridx_sh[:, None, None, :], axis=2)[:, :, 0]

            # Left edge of this device's sweep: halo from the left
            # neighbor, or the bordered boundary for device 0.
            hcol0 = jnp.where(d == 0, left_b(r0 + iic + 1), halo_h)
            fcol0 = jnp.where(d == 0, jnp.full((Qc, B), neg), halo_f)
            htop0 = jnp.where(d == 0, left_b(r0), halo_top)   # H[r0-1, j-1]

            ig = r0 + iic                                     # global i
            if want_stats:
                qidx_c = jax.lax.dynamic_slice(qidx, (r0, 0), (Qc, B))
                z = jnp.zeros((Qc, B), I32)
                # halo_sc rows: Hm/Hs/Hl, Fm/Fs/Fl columns of the left
                # neighbor's final column
                hm0 = jnp.where(d == 0, z, halo_sc[0])
                hs0 = jnp.where(d == 0, z, halo_sc[1])
                hl0 = jnp.where(d == 0, left_len(r0 + iic + 1), halo_sc[2])
                fm0 = jnp.where(d == 0, z, halo_sc[3])
                fs0 = jnp.where(d == 0, z, halo_sc[4])
                fl0 = jnp.where(d == 0, z, halo_sc[5])
                zb = jnp.zeros((B,), I32)
                tm0 = jnp.where(d == 0, zb, halo_sc[6][0])
                ts0 = jnp.where(d == 0, zb, halo_sc[7][0])
                tl0 = jnp.where(d == 0, left_len(r0) * jnp.ones((B,), I32),
                                halo_sc[8][0])

            def colstep(cc, xs):
                if want_stats:
                    (hcol, fcol, htopd, hm, hs, hl, fm, fs, fl,
                     tophm, tophs, tophl) = cc
                    s_col, dH_j, dPM_j, dst_j, dE_j, rcol, jl = xs
                else:
                    hcol, fcol, htopd = cc
                    s_col, dH_j, dPM_j, dst_j, dE_j, rcol, jl = xs
                jg = jg0 + jl                              # global j
                from_open_f = hcol - open_ >= fcol - ext
                F = jnp.maximum(hcol - open_, fcol - ext)
                # Interior H[r0-1, j]; for the top chunk this is the
                # bordered boundary cell H[0][j+1].
                toph = jnp.where(t == 0, top_b(jg + 1), dH_j)
                hdiag = jnp.where(iic == 0, htopd,
                                  jnp.roll(hcol, 1, axis=0))
                diag = hdiag + s_col
                htemp = jnp.maximum(diag, F)
                if local:
                    htemp = jnp.maximum(htemp, 0)
                # A-domain slope min(open, ext): exact closed form of
                # golden's E recurrence for ANY penalties
                a = htemp - open_ + e_ext * ig
                seed = jnp.where(t == 0, top_b(jg + 1) - open_ - e_ext,
                                 dPM_j)
                if want_stats:
                    im = (qidx_c == rcol[None, :]).astype(I32)
                    m_d = jnp.where(iic == 0, tophm[None, :],
                                    jnp.roll(hm, 1, axis=0))
                    s_d = jnp.where(iic == 0, tophs[None, :],
                                    jnp.roll(hs, 1, axis=0))
                    l_d = jnp.where(iic == 0, tophl[None, :],
                                    jnp.roll(hl, 1, axis=0))
                    Dm = m_d + im
                    Ds = s_d + (s_col > 0).astype(I32)
                    Dl = l_d + 1
                    Fm = jnp.where(from_open_f, hm, fm)
                    Fs = jnp.where(from_open_f, hs, fs)
                    Fl = jnp.where(from_open_f, hl, fl) + 1
                    t_diag = diag >= F
                    Tm = jnp.where(t_diag, Dm, Fm)
                    Ts = jnp.where(t_diag, Ds, Fs)
                    Tlm = jnp.where(t_diag, Dl, Fl) - ig
                    if local:
                        zt = htemp == 0
                        Tm = jnp.where(zt, 0, Tm)
                        Ts = jnp.where(zt, 0, Ts)
                        Tlm = jnp.where(zt, -ig, Tlm)
                    seed_l = top_len(jg + 1) + 1
                    sm = jnp.where(t == 0, jnp.zeros((B,), I32), dst_j[3])
                    ss_ = jnp.where(t == 0, jnp.zeros((B,), I32), dst_j[4])
                    sl = jnp.where(t == 0, seed_l * jnp.ones((B,), I32),
                                   dst_j[5])
                    pm, (Em, Es, Elm) = _prefix_argmax_exclusive(
                        a, (Tm, Ts, Tlm), iic, seed,
                        (sm[None, :], ss_[None, :], sl[None, :]))
                    E = pm - e_ext * (ig - 1)
                    El = Elm + ig
                else:
                    pm = _prefix_max_exclusive(a, iic, seed)
                    E = pm - e_ext * (ig - 1)
                H = jnp.maximum(htemp, E)
                newPM = jnp.maximum(seed, a.max(axis=0))
                if want_trace:
                    # Flag emission, bit-identical to golden: the same
                    # Gotoh comparisons over the same E/F/H columns; E of the row above comes from the carried
                    # per-column down state across query chunks.
                    fflag = jnp.where(from_open_f, TRACE_DIAG_F,
                                      TRACE_DEL_F)
                    h_up = jnp.where(iic == 0, toph[None, :],
                                     jnp.roll(H, 1, axis=0))
                    e_top = jnp.where(t == 0, jnp.full((B,), neg, I32),
                                      dE_j)
                    e_up = jnp.where(iic == 0, e_top[None, :],
                                     jnp.roll(E, 1, axis=0))
                    eflag = jnp.where(h_up - open_ >= e_up - ext,
                                      TRACE_DIAG_E, TRACE_INS_E)
                    take_diag_t = (diag >= E) & (diag >= F)
                    hflag = jnp.where(
                        take_diag_t, TRACE_DIAG,
                        jnp.where(E >= F, TRACE_INS, TRACE_DEL))
                    if local:
                        pre = jnp.maximum(jnp.maximum(diag, E), F)
                        hflag = jnp.where(pre <= 0, 0, hflag)
                    tr = (hflag | eflag | fflag).astype(jnp.int8)
                else:
                    tr = jnp.zeros((1, B), jnp.int8)
                ndE_j = E[-1, :]
                if want_stats:
                    take_diag = (diag >= E) & (diag >= F)
                    take_e = (~take_diag) & (E >= F)
                    Hm = jnp.where(take_diag, Dm, jnp.where(take_e, Em, Fm))
                    Hs = jnp.where(take_diag, Ds, jnp.where(take_e, Es, Fs))
                    Hl = jnp.where(take_diag, Dl, jnp.where(take_e, El, Fl))
                    if local:
                        zc = H <= 0
                        Hm = jnp.where(zc, 0, Hm)
                        Hs = jnp.where(zc, 0, Hs)
                        Hl = jnp.where(zc, 0, Hl)
                    # cross-chunk prefix payloads: combine exclusive scan
                    # at the last row with the last row itself
                    lastA = a[-1, :]
                    prev = pm[-1, :]
                    take_last = lastA >= prev
                    nPMm = jnp.where(take_last, Tm[-1, :], Em[-1, :])
                    nPMs = jnp.where(take_last, Ts[-1, :], Es[-1, :])
                    nPMl = jnp.where(take_last, Tlm[-1, :], Elm[-1, :])
                    ndst = jnp.stack([Hm[-1, :], Hs[-1, :], Hl[-1, :],
                                      nPMm, nPMs, nPMl])
                    # toph stats for the NEXT column: stats of (r0-1, jg)
                    tophm_n = jnp.where(t == 0, jnp.zeros((B,), I32),
                                        dst_j[0])
                    tophs_n = jnp.where(t == 0, jnp.zeros((B,), I32),
                                        dst_j[1])
                    tophl_n = jnp.where(
                        t == 0, top_len(jg + 1) * jnp.ones((B,), I32),
                        dst_j[2])
                    ys = (H[-1, :], newPM, ndst, H, Hm, Hs, Hl, toph,
                          ndE_j, tr)
                    return ((H, F, toph, Hm, Hs, Hl, Fm, Fs, Fl,
                             tophm_n, tophs_n, tophl_n), ys)
                ys = (H[-1, :], newPM, jnp.zeros((6, B), I32), H,
                      H, H, H, toph, ndE_j, tr)
                return (H, F, toph), ys

            if want_stats:
                cc0 = (hcol0, fcol0, htop0, hm0, hs0, hl0, fm0, fs0, fl0,
                       tm0, ts0, tl0)
            else:
                cc0 = (hcol0, fcol0, htop0)
            cols = (
                jnp.moveaxis(stile, 0, 0),                 # (C, Qc, B)
                dHlast, dPM, dstats, dEdown,               # (C, ...)
                jnp.swapaxes(ridx_sh, 0, 0),               # (C, B)
                jnp.arange(C, dtype=I32),
            )
            ccf, (nHlast, nPM, ndstats, Hall, Hmall, Hsall, Hlall, _tops,
                  ndE, trs) = \
                jax.lax.scan(colstep, cc0, cols)
            hfin, ffin, htopfin = ccf[0], ccf[1], ccf[2]

            # -- candidate tracking over the freshly filled tile --------
            # Hall: (C, Qc, B); global coords jg = jg0 + c, ig = r0 + q.
            jgv = (jg0 + jnp.arange(C, dtype=I32))[:, None, None]
            igv = ig[None, :, :]
            inseq = (igv < qlen) & (jgv < rlen)
            last_row = igv == qlen - 1
            last_col = jgv == rlen - 1
            if local:
                cand = inseq & (Hall > 0)
            elif mode == "sg":
                sel = last_row & last_col
                if qe:
                    sel = sel | last_row
                if de:
                    sel = sel | last_col
                cand = inseq & sel
            else:
                cand = inseq & last_row & last_col
            Hc = jnp.where(cand & active, Hall, neg)
            stepb = Hc.max(axis=(0, 1))                          # (B,)
            cellmax = Hc == stepb[None, None, :]
            stepi = jnp.where(cellmax, igv, I32(Qp)).min(axis=(0, 1))
            stepj = jnp.where(cellmax & (igv == stepi[None, None, :]),
                              jgv, I32(Rp)).min(axis=(0, 1))
            better = (stepb > best) | (
                (stepb == best) & (stepb > neg) & (
                    (stepi < bi) | ((stepi == bi) & (stepj < bj))))
            best = jnp.where(better, stepb, best)
            bi = jnp.where(better, stepi, bi)
            bj = jnp.where(better, stepj, bj)
            if want_stats:
                winner = (cellmax & (igv == stepi[None, None, :])
                          & (jgv == stepj[None, None, :]))
                pick = lambda M: jnp.where(winner, M, 0).max(axis=(0, 1))
                stepstats = jnp.stack([pick(Hmall), pick(Hsall),
                                       pick(Hlall)])
                bstats = jnp.where(better[None, :], stepstats, bstats)

            # -- state updates ------------------------------------------
            upd = lambda old, new: jnp.where(active, new, old)
            dHlast = upd(dHlast, nHlast)
            dPM = upd(dPM, nPM)
            dstats = jnp.where(active, ndstats, dstats)
            dEdown = upd(dEdown, ndE)
            if want_trace:
                # write this chunk's freshly produced (Qc, C, B) flag
                # tile into the device-local plane at chunk row tc
                tile = jnp.swapaxes(trs, 0, 1)[None]       # (1, Qc, C, B)
                old = jax.lax.dynamic_slice(
                    tbuf, (tc, 0, 0, 0), (1, Qc, C, B))
                tbuf = jax.lax.dynamic_update_slice(
                    tbuf, jnp.where(active, tile, old), (tc, 0, 0, 0))
            # halo to the right neighbor (ICI ring step)
            perm = [(k, k + 1) for k in range(D - 1)]
            halo_h = jax.lax.ppermute(upd(halo_h, hfin), axis, perm)
            halo_f = jax.lax.ppermute(upd(halo_f, ffin), axis, perm)
            halo_top = jax.lax.ppermute(upd(halo_top, htopfin), axis, perm)
            if want_stats:
                nsc = jnp.stack([
                    ccf[3], ccf[4], ccf[5], ccf[6], ccf[7], ccf[8],
                    ccf[9][None, :] * jnp.ones((Qc, B), I32),
                    ccf[10][None, :] * jnp.ones((Qc, B), I32),
                    ccf[11][None, :] * jnp.ones((Qc, B), I32)])
                halo_sc = jax.lax.ppermute(
                    jnp.where(active, nsc, halo_sc), axis, perm)
            return (dHlast, dPM, dstats, halo_h, halo_f, halo_sc, halo_top,
                    best, bi, bj, bstats, dEdown, tbuf), None

        carry0 = (
            jnp.zeros((C, B), I32), jnp.zeros((C, B), I32),
            jnp.zeros((C, 6, B), I32),
            jnp.zeros((Qc, B), I32), jnp.zeros((Qc, B), I32),
            jnp.zeros((9 if want_stats else 1, Qc, B), I32),
            jnp.zeros((B,), I32),
            jnp.full((B,), neg), jnp.full((B,), I32(Qp)),
            jnp.full((B,), I32(Rp)),
            jnp.zeros((3, B), I32),
            jnp.zeros((C, B), I32),
            jnp.zeros((S, Qc, C, B) if want_trace else (1, 1, 1, 1),
                      jnp.int8),
        )
        carry, _ = jax.lax.scan(
            superstep, carry0, jnp.arange(S + D - 1, dtype=I32))
        best, bi, bj, bstats = carry[7], carry[8], carry[9], carry[10]
        if want_trace:
            # (S, Qc, C, B) -> (Qp, C, B): this device's column shard
            tplane = carry[12].reshape(Qp, C, B)
        # Combine candidates across devices: max score, then min (i, j).
        allb = jax.lax.all_gather(
            jnp.stack([best, bi, bj, bstats[0], bstats[1], bstats[2]]),
            axis)                                               # (D, 6, B)
        gb = allb[:, 0, :].max(axis=0)
        is_max = allb[:, 0, :] == gb[None, :]
        gi = jnp.where(is_max, allb[:, 1, :], I32(Qp)).min(axis=0)
        gj = jnp.where(is_max & (allb[:, 1, :] == gi[None, :]),
                       allb[:, 2, :], I32(Rp)).min(axis=0)
        win = is_max & (allb[:, 1, :] == gi[None, :]) & \
            (allb[:, 2, :] == gj[None, :])
        gm = jnp.where(win, allb[:, 3, :], 0).max(axis=0)
        gs = jnp.where(win, allb[:, 4, :], 0).max(axis=0)
        gl = jnp.where(win, allb[:, 5, :], 0).max(axis=0)
        if want_trace:
            return gb, gi, gj, gm, gs, gl, tplane
        return gb, gi, gj, gm, gs, gl

    spec_rep = P()
    out_specs = (spec_rep,) * 6
    if want_trace:
        out_specs = out_specs + (P(None, axis, None),)
    fn = _shard_map(
        device_fn, mesh,
        in_specs=(spec_rep, P(axis), spec_rep, spec_rep, spec_rep),
        out_specs=out_specs,
    )
    res = fn(
        jnp.asarray(profile, I32), jnp.asarray(ridx, I32),
        jnp.asarray(qlen, I32), jnp.asarray(rlen, I32),
        jnp.asarray(qidx, I32))
    best, bi, bj, bm, bs, bl = res[:6]
    tplane = res[6] if want_trace else None

    if mode == "nw":
        out = {"score": best, "end_query": qlen - 1, "end_ref": rlen - 1}
        if want_stats:
            out.update(matches=bm, similar=bs, length=bl)
    else:
        empty = best <= 0 if local else jnp.zeros_like(best, bool)
        out = {
            "score": jnp.where(empty, 0, best) if local else best,
            "end_query": jnp.where(empty, 0, bi),
            "end_ref": jnp.where(empty, 0, bj),
        }
        if want_stats:
            out["matches"] = jnp.where(empty, 0, bm)
            out["similar"] = jnp.where(empty, 0, bs)
            out["length"] = jnp.where(empty, 0, bl)
    if want_trace:
        # (Qp, Rp, B) column-sharded -> engine-convention (B, Qp, Rp)
        out["trace_table"] = jnp.transpose(tplane, (2, 0, 1))
    return out


def seqpar_cigars(out, queries, references, mode,
                  free=(False,) * 4) -> list[str]:
    """Host traceback over a seqpar trace result -> CIGAR strings.

    ``out`` is a ``seqpar_align(..., outputs="trace")`` result; the flag
    plane is gathered to the host (each process receives its addressable
    shards) and walked in ONE native batch (native/ptwalk.cc, the same
    walk the engine's ``Aligner.cigars`` uses — golden fallback when no
    compiler), so strings are bit-identical to the single-chip path.
    """
    from ..constants import cigar_runs_string
    from ..golden.model import free_flags, walk_trace
    from ..native import walker

    trace = np.asarray(out["trace_table"])
    eq = np.asarray(out["end_query"])
    er = np.asarray(out["end_ref"])
    scores = np.asarray(out["score"])
    live = [b for b in range(len(queries))
            if mode != "sw" or scores[b] > 0]
    ff = free if mode == "sg" else free_flags(mode)
    qb, _, db, _ = ff
    walked = walker.walk_batch(
        [trace[b, :len(queries[b]), :len(references[b])] for b in live],
        [queries[b] for b in live], [references[b] for b in live],
        [int(eq[b]) for b in live], [int(er[b]) for b in live],
        local=mode == "sw", qb=qb, db=db)
    cigars = [""] * len(queries)
    if walked is not None:
        for k, b in enumerate(live):
            cigars[b] = cigar_runs_string(walked[k][0])
        return cigars
    for b in live:
        q, r = queries[b], references[b]
        walk = walk_trace(trace[b, :len(q), :len(r)], q, r,
                          int(eq[b]), int(er[b]), mode, free)
        cigars[b] = walk.cigar_string()
    return cigars
