"""Batched anti-diagonal wavefront DP fill (XLA path).

This is the plain-XLA reformulation of parasail's kernel matrix
(reference L4: the ``{nw,sg*,sw} x {outputs} x {striped,scan,diag}``
C kernels, SURVEY.md §2.2).  parasail vectorises ONE pair across SIMD
lanes with three different strategies; here many pairs ride the vector
lanes and each pair is swept anti-diagonally, because cells on one
anti-diagonal of the affine-gap recurrence have no intra-step
dependency at all:

    E[i,j] = max(H[i-1,j] - open, E[i-1,j] - ext)    (vertical,  diag d-1)
    F[i,j] = max(H[i,j-1] - open, F[i,j-1] - ext)    (horizontal, diag d-1)
    H[i,j] = max(H[i-1,j-1] + S[i,j], E[i,j], F[i,j])   (diag d-2)

so a whole (B, Q) slab updates per step with pure element-wise work.
The striped/scan/diag knob therefore collapses to one formulation; the
engine still records and reports the requested strategy flag
(reference predicates: src/alignment/mod.rs:448-460).

All variants are computed in int32; narrow widths (8/16) are emulated
bit-faithfully by saturation *detection* (per-pair ``saturated`` flags)
in one pass — the replacement for parasail's 8->16 retry ladder
(src/aligner/mod.rs:125-126).

This module serves every output class at any shape and is verified
against the golden model; the GPU kernel (ops/gpu_fill.py) serves the
short-pair score/stats/trace classes and is verified against both.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

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


def _shift1(x, fill):
    """shifted[.., i] = x[.., i-1]; position 0 gets ``fill`` (same shape-1)."""
    y = jnp.roll(x, 1, axis=-1)
    return y.at[..., 0].set(fill)


@functools.partial(
    jax.jit,
    static_argnames=("mode", "free", "outputs", "width", "banded"),
)
def wavefront_align(
    profile,       # (B, Qp, A) int32: per-pair query profile P[b,i,a]
    qidx,          # (B, Qp) int32: mapped query indices (for `matches`)
    ridx,          # (B, Rp) int32: mapped reference indices
    qlen,          # (B,) int32
    rlen,          # (B,) int32
    *,
    open_,         # () int32 gap-open penalty (traced: no recompile per value)
    ext,           # () int32 gap-extend penalty (traced)
    mode: str,
    free: tuple[bool, bool, bool, bool],
    outputs: str,
    width: str = "32",
    banded: bool = False,
    bandwidth=0,   # () int32, traced; cells with |i - j| > bandwidth excluded
):
    """Run the batched wavefront fill; returns a dict of device arrays.

    Always returned: ``score``, ``end_query``, ``end_ref`` (B,) int32 and
    ``saturated`` (B,) bool.  Additional keys per output class:

    - stats*:   ``matches``, ``similar``, ``length`` (B,)
    - table(s): ``score_table`` (+ ``matches/similar/length_table``) (B,Qp,Rp)
    - rowcol:   ``score_row`` (B,Rp) / ``score_col`` (B,Qp) (+ stats rows/cols)
    - trace:    ``trace_table`` (B,Qp,Rp) int8 flags

    Width semantics (the replacement for parasail's retry ladder,
    reference src/aligner/mod.rs:125-126): scores are always exact int32;
    ``"8"``/``"16"`` flag pairs whose H would overflow that integer width,
    ``"sat"`` detects both thresholds in ONE pass — ``saturated`` reports
    the 16-bit flag (parasail's sat = 8-bit, retry 16-bit, saturated only
    if 16-bit overflows too) and ``promoted`` reports the 8-bit flag.
    """
    # profile/qidx may be (1, Qp, ...) shared across the batch (profile
    # reuse, reference README.md:38-63) — broadcasting handles the rest.
    _, Qp, A = profile.shape
    B, Rp = ridx.shape
    D = Qp + Rp - 1
    local = mode == "sw"
    qb, qe, db, de = (True,) * 4 if local else free
    want_stats = outputs in ("stats", "stats_table", "stats_rowcol")
    want_tables = outputs in ("table", "stats_table")
    want_stats_tables = outputs == "stats_table"
    want_rowcol = outputs in ("rowcol", "stats_rowcol")
    want_stats_rowcol = outputs == "stats_rowcol"
    want_trace = outputs == "trace"

    neg = jnp.int32(NEG_INF32)
    open_ = jnp.asarray(open_, dtype=I32)
    ext = jnp.asarray(ext, dtype=I32)
    bw = jnp.asarray(bandwidth, dtype=I32)
    ivec = jnp.arange(Qp, dtype=I32)                       # (Qp,)

    # Reference indices re-packed for contiguous per-diagonal slicing:
    # rdiag_d[b, i] = ridx[b, d - i]  ==  rev(ridx)[b, Rp-1-d+i  + pad].
    r_rev = jnp.flip(ridx, axis=1)
    r_rev_padded = jnp.pad(r_rev, ((0, 0), (Qp, Qp)))      # (B, Rp + 2Qp)

    # Boundary value of the bordered DP row/col at c consumed chars.
    # Under banding, boundary cells beyond the band are unreachable
    # (bordered band: |i - j| <= bandwidth).
    def top_boundary(c):  # H[0][c]
        base = jnp.where(c > 0, -(open_ + (c - 1) * ext), 0).astype(I32)
        base = jnp.zeros_like(base) if qb else base
        return jnp.where(c <= bw, base, neg) if banded else base

    def left_boundary(c):  # H[c][0]
        base = jnp.where(c > 0, -(open_ + (c - 1) * ext), 0).astype(I32)
        base = jnp.zeros_like(base) if db else base
        return jnp.where(c <= bw, base, neg) if banded else base

    def top_len(c):
        return jnp.zeros_like(c) if qb else c.astype(I32)

    def left_len(c):
        return jnp.zeros_like(c) if db else c.astype(I32)

    zero_b_qp = jnp.zeros((B, Qp), dtype=I32)

    carry = {
        "H1": jnp.full((B, Qp), neg),   # H on diagonal d-1
        "H2": jnp.full((B, Qp), neg),   # H on diagonal d-2
        "E1": jnp.full((B, Qp), neg),   # E on diagonal d-1
        "F1": jnp.full((B, Qp), neg),   # F on diagonal d-1
        # Running best (sw / sg end-candidate accumulation).
        "best": jnp.full((B,), neg),
        "best_i": jnp.full((B,), I32(Qp)),
        "best_j": jnp.full((B,), I32(Rp)),
        # Width-emulation saturation detection.
        "sat": jnp.zeros((B,), dtype=bool),
    }
    if width == "sat":
        carry["sat8"] = jnp.zeros((B,), dtype=bool)
    if want_stats:
        for k in ("Hm1", "Hs1", "Hl1", "Hm2", "Hs2", "Hl2",
                  "Em1", "Es1", "El1", "Fm1", "Fs1", "Fl1"):
            carry[k] = zero_b_qp
        for k in ("best_m", "best_s", "best_l"):
            carry[k] = jnp.zeros((B,), dtype=I32)
    if want_rowcol:
        carry["row"] = jnp.zeros((B, Rp), dtype=I32)
        carry["col"] = jnp.zeros((B, Qp), dtype=I32)
        if want_stats_rowcol:
            for k in ("rowm", "rows", "rowl"):
                carry[k] = jnp.zeros((B, Rp), dtype=I32)
            for k in ("colm", "cols", "coll"):
                carry[k] = jnp.zeros((B, Qp), dtype=I32)

    wmax = jnp.int32(WIDTH_MAX[width if width != "sat" else "16"]) \
        if width in ("8", "16", "sat") else None
    wmin = jnp.int32(WIDTH_MIN[width if width != "sat" else "16"]) \
        if width in ("8", "16", "sat") else None
    wmax8 = jnp.int32(WIDTH_MAX["8"]) if width == "sat" else None
    wmin8 = jnp.int32(WIDTH_MIN["8"]) if width == "sat" else None

    def step(carry, d):
        jvec = d - ivec                                   # (Qp,) ref index per lane
        on_diag = (jvec >= 0) & (jvec < Rp)               # cell exists in padded grid
        in_seq = on_diag & (ivec[None, :] < qlen[:, None]) & (jvec[None, :] < rlen[:, None])

        # Substitution scores along the diagonal.
        start = Rp - 1 - d + Qp
        rdiag = jax.lax.dynamic_slice_in_dim(r_rev_padded, start, Qp, axis=1)  # (B, Qp)
        s = jnp.take_along_axis(profile, rdiag[:, :, None], axis=2)[:, :, 0]

        i0 = ivec == 0            # top row cells
        j0 = jvec == 0            # left col cells

        # Predecessors with boundary injection.
        h_up = jnp.where(i0[None, :], top_boundary(jvec + 1)[None, :], _shift1(carry["H1"], 0))
        e_up = jnp.where(i0[None, :], neg, _shift1(carry["E1"], 0))
        h_left = jnp.where(j0[None, :], left_boundary(ivec + 1)[None, :], carry["H1"])
        f_left = jnp.where(j0[None, :], neg, carry["F1"])
        h_diag = jnp.where(
            i0[None, :], top_boundary(jvec)[None, :],
            jnp.where(j0[None, :], left_boundary(ivec)[None, :], _shift1(carry["H2"], 0)),
        )

        e_open = h_up - open_
        e_ext = e_up - ext
        E = jnp.maximum(e_open, e_ext)
        from_open_e = e_open >= e_ext

        f_open = h_left - open_
        f_ext = f_left - ext
        F = jnp.maximum(f_open, f_ext)
        from_open_f = f_open >= f_ext

        diag = h_diag + s
        H = jnp.maximum(jnp.maximum(diag, E), F)
        take_diag = diag >= jnp.maximum(E, F)
        take_e = (~take_diag) & (E >= F)

        clamp0 = jnp.zeros_like(H, dtype=bool)
        if local:
            clamp0 = H <= 0
            H = jnp.maximum(H, 0)

        if banded:
            in_band = (jnp.abs(ivec - jvec) <= bw)[None, :]
            H = jnp.where(in_band, H, neg)
            E = jnp.where(in_band, E, neg)
            F = jnp.where(in_band, F, neg)

        new = dict(carry)
        new["H2"] = carry["H1"]
        new["H1"] = jnp.where(on_diag[None, :], H, carry["H1"])
        new["E1"] = jnp.where(on_diag[None, :], E, carry["E1"])
        new["F1"] = jnp.where(on_diag[None, :], F, carry["F1"])

        # -- stats accumulators ------------------------------------------------
        if want_stats:
            m_up = jnp.where(i0[None, :], 0, _shift1(carry["Hm1"], 0))
            s_up = jnp.where(i0[None, :], 0, _shift1(carry["Hs1"], 0))
            l_up = jnp.where(i0[None, :], top_len(jvec + 1)[None, :], _shift1(carry["Hl1"], 0))
            em_up = jnp.where(i0[None, :], 0, _shift1(carry["Em1"], 0))
            es_up = jnp.where(i0[None, :], 0, _shift1(carry["Es1"], 0))
            el_up = jnp.where(i0[None, :], 0, _shift1(carry["El1"], 0))
            m_left = jnp.where(j0[None, :], 0, carry["Hm1"])
            s_left = jnp.where(j0[None, :], 0, carry["Hs1"])
            l_left = jnp.where(j0[None, :], left_len(ivec + 1)[None, :], carry["Hl1"])
            fm_left = jnp.where(j0[None, :], 0, carry["Fm1"])
            fs_left = jnp.where(j0[None, :], 0, carry["Fs1"])
            fl_left = jnp.where(j0[None, :], 0, carry["Fl1"])
            m_diag = jnp.where(
                i0[None, :], 0, jnp.where(j0[None, :], 0, _shift1(carry["Hm2"], 0)))
            s_diag = jnp.where(
                i0[None, :], 0, jnp.where(j0[None, :], 0, _shift1(carry["Hs2"], 0)))
            l_diag = jnp.where(
                i0[None, :], top_len(jvec)[None, :],
                jnp.where(j0[None, :], left_len(ivec)[None, :], _shift1(carry["Hl2"], 0)))

            Em = jnp.where(from_open_e, m_up, em_up)
            Es = jnp.where(from_open_e, s_up, es_up)
            El = jnp.where(from_open_e, l_up, el_up) + 1
            Fm = jnp.where(from_open_f, m_left, fm_left)
            Fs = jnp.where(from_open_f, s_left, fs_left)
            Fl = jnp.where(from_open_f, l_left, fl_left) + 1

            is_match = (qidx == rdiag).astype(I32)
            Dm = m_diag + is_match
            Ds = s_diag + (s > 0).astype(I32)
            Dl = l_diag + 1

            Hm = jnp.where(take_diag, Dm, jnp.where(take_e, Em, Fm))
            Hs = jnp.where(take_diag, Ds, jnp.where(take_e, Es, Fs))
            Hl = jnp.where(take_diag, Dl, jnp.where(take_e, El, Fl))
            if local:
                Hm = jnp.where(clamp0, 0, Hm)
                Hs = jnp.where(clamp0, 0, Hs)
                Hl = jnp.where(clamp0, 0, Hl)

            new["Hm2"], new["Hs2"], new["Hl2"] = carry["Hm1"], carry["Hs1"], carry["Hl1"]
            upd = lambda old, v: jnp.where(on_diag[None, :], v, old)
            new["Hm1"], new["Hs1"], new["Hl1"] = upd(carry["Hm1"], Hm), upd(carry["Hs1"], Hs), upd(carry["Hl1"], Hl)
            new["Em1"], new["Es1"], new["El1"] = upd(carry["Em1"], Em), upd(carry["Es1"], Es), upd(carry["El1"], El)
            new["Fm1"], new["Fs1"], new["Fl1"] = upd(carry["Fm1"], Fm), upd(carry["Fs1"], Fs), upd(carry["Fl1"], Fl)

        # -- saturation detection (narrow-width emulation) ---------------------
        if wmax is not None:
            hit = in_seq & ((H >= wmax) | (H <= wmin))
            new["sat"] = carry["sat"] | hit.any(axis=1)
        if wmax8 is not None:
            hit8 = in_seq & ((H >= wmax8) | (H <= wmin8))
            new["sat8"] = carry["sat8"] | hit8.any(axis=1)

        # -- end-cell accumulation --------------------------------------------
        if local:
            cand_ok = in_seq & (H > 0)
        elif mode == "sg":
            last_row = (ivec[None, :] == qlen[:, None] - 1)
            last_col = (jvec[None, :] == rlen[:, None] - 1)
            sel = jnp.zeros_like(last_row)
            if qe:
                sel = sel | last_row
            if de:
                sel = sel | last_col
            sel = sel | (last_row & last_col)   # corner is always a candidate
            cand_ok = in_seq & sel
        else:  # nw: only the corner cell
            cand_ok = (
                (ivec[None, :] == qlen[:, None] - 1)
                & (jvec[None, :] == rlen[:, None] - 1)
            )

        Hc = jnp.where(cand_ok, H, neg)
        step_best = Hc.max(axis=1)                                   # (B,)
        step_i = jnp.where(Hc == step_best[:, None], ivec[None, :], I32(Qp)).min(axis=1)
        step_j = d - step_i
        better = (step_best > carry["best"]) | (
            (step_best == carry["best"]) & (step_best > neg) & (step_i < carry["best_i"])
        )
        new["best"] = jnp.where(better, step_best, carry["best"])
        new["best_i"] = jnp.where(better, step_i, carry["best_i"])
        new["best_j"] = jnp.where(better, step_j, carry["best_j"])
        if want_stats:
            bi = step_i.clip(0, Qp - 1)
            pick = lambda M: jnp.take_along_axis(M, bi[:, None], axis=1)[:, 0]
            new["best_m"] = jnp.where(better, pick(new["Hm1"]), carry["best_m"])
            new["best_s"] = jnp.where(better, pick(new["Hs1"]), carry["best_s"])
            new["best_l"] = jnp.where(better, pick(new["Hl1"]), carry["best_l"])

        # -- rowcol accumulation ----------------------------------------------
        if want_rowcol:
            lastrow = in_seq & (ivec[None, :] == qlen[:, None] - 1)
            lastcol = in_seq & (jvec[None, :] == rlen[:, None] - 1)
            # scatter one value per pair at column j = d - (qlen-1)
            jcol = (d - (qlen - 1)).clip(0, Rp - 1)                  # (B,)
            icol = (d - (rlen - 1)).clip(0, Qp - 1)
            brange = jnp.arange(B)

            rv = jnp.take_along_axis(H, (qlen - 1).clip(0, Qp - 1)[:, None], axis=1)[:, 0]
            rok = lastrow.any(axis=1)
            new["row"] = carry["row"].at[brange, jcol].set(
                jnp.where(rok, rv, carry["row"][brange, jcol]))
            cv = jnp.take_along_axis(H, icol[:, None], axis=1)[:, 0]
            cok = lastcol.any(axis=1)
            new["col"] = carry["col"].at[brange, icol].set(
                jnp.where(cok, cv, carry["col"][brange, icol]))
            if want_stats_rowcol:
                for key, M in (("m", Hm), ("s", Hs), ("l", Hl)):
                    rv = jnp.take_along_axis(M, (qlen - 1).clip(0, Qp - 1)[:, None], axis=1)[:, 0]
                    new["row" + key] = carry["row" + key].at[brange, jcol].set(
                        jnp.where(rok, rv, carry["row" + key][brange, jcol]))
                    cv = jnp.take_along_axis(M, icol[:, None], axis=1)[:, 0]
                    new["col" + key] = carry["col" + key].at[brange, icol].set(
                        jnp.where(cok, cv, carry["col" + key][brange, icol]))

        # -- per-step emitted slabs -------------------------------------------
        ys = {}
        if want_trace:
            eflag = jnp.where(from_open_e, TRACE_DIAG_E, TRACE_INS_E)
            fflag = jnp.where(from_open_f, TRACE_DIAG_F, TRACE_DEL_F)
            hflag = jnp.where(
                take_diag, TRACE_DIAG, jnp.where(take_e, TRACE_INS, TRACE_DEL))
            if local:
                hflag = jnp.where(clamp0, 0, hflag)
            ys["trace"] = (hflag | eflag | fflag).astype(jnp.int8)
        if want_tables:
            ys["H"] = H
            if want_stats_tables:
                ys["Hm"], ys["Hs"], ys["Hl"] = Hm, Hs, Hl
        return new, ys

    carry, ys = jax.lax.scan(step, carry, jnp.arange(D, dtype=I32))

    # -- final readout ---------------------------------------------------------
    out = {"saturated": carry["sat"]}
    if width == "sat":
        out["promoted"] = carry["sat8"]
    if mode == "nw":
        out["score"] = carry["best"]
        out["end_query"] = qlen - 1
        out["end_ref"] = rlen - 1
    else:
        empty = carry["best"] <= 0 if local else jnp.zeros_like(carry["best"], dtype=bool)
        out["score"] = jnp.where(empty, 0, carry["best"]) if local else carry["best"]
        out["end_query"] = jnp.where(empty, 0, carry["best_i"])
        out["end_ref"] = jnp.where(empty, 0, carry["best_j"])
    if want_stats:
        if mode == "nw":
            out["matches"] = carry["best_m"]
            out["similar"] = carry["best_s"]
            out["length"] = carry["best_l"]
        else:
            empty = carry["best"] <= 0 if local else jnp.zeros_like(carry["best"], dtype=bool)
            out["matches"] = jnp.where(empty, 0, carry["best_m"])
            out["similar"] = jnp.where(empty, 0, carry["best_s"])
            out["length"] = jnp.where(empty, 0, carry["best_l"])

    def undiag(slab):
        # slab: (D, B, Qp) diag-major -> (B, Qp, Rp) row-major
        ii = jnp.arange(Qp)[:, None]
        jj = jnp.arange(Rp)[None, :]
        dd = ii + jj                                 # (Qp, Rp)
        return slab[dd, :, ii].transpose(2, 0, 1)

    if want_tables:
        out["score_table"] = undiag(ys["H"])
        if want_stats_tables:
            out["matches_table"] = undiag(ys["Hm"])
            out["similar_table"] = undiag(ys["Hs"])
            out["length_table"] = undiag(ys["Hl"])
    if want_rowcol:
        out["score_row"], out["score_col"] = carry["row"], carry["col"]
        if want_stats_rowcol:
            out["matches_row"], out["matches_col"] = carry["rowm"], carry["colm"]
            out["similar_row"], out["similar_col"] = carry["rows"], carry["cols"]
            out["length_row"], out["length_col"] = carry["rowl"], carry["coll"]
    if want_trace:
        out["trace_table"] = undiag(ys["trace"])
    return out
