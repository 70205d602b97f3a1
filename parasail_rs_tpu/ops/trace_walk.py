"""Device-side batched traceback walk over trace-flag planes.

The reference extracts CIGARs by a per-pair sequential host walk through
the trace table (parasail_result_get_cigar, src/alignment/mod.rs:390-419).
Shipping the full (B, Qp, Rp) int8 flag plane to the host first costs
B*Qp*Rp bytes of device->host transfer to feed a walk that only reads
O(qlen+rlen) cells per pair.  This module walks ON DEVICE instead: one
``lax.scan`` of Qp+Rp steps carries (i, j, state) for every pair in the
batch and gathers exactly the flag byte each pair's walk visits,
emitting compact per-step opcodes.  The host then fetches B*(Qp+Rp)
bytes (~80x less than the plane) and run-length encodes.

Semantics are bit-identical to golden.model.walk_trace (the affine
three-state machine H/E/F with parasail's flag encoding,
reference trace flags src/alignment/table.rs:127-142), including the
local-mode ZERO stop and the non-local boundary gap runs for penalized
(non-free) leading gaps.
"""

from __future__ import annotations

import numpy as np

from ..constants import (
    TRACE_DEL,
    TRACE_DIAG,
    TRACE_DIAG_E,
    TRACE_DIAG_F,
    TRACE_H_BITS,
    TRACE_INS,
)

# step opcodes emitted by the device walk (backward order)
OP_NONE, OP_EQ, OP_X, OP_I, OP_D = 0, 1, 2, 3, 4
# opcode -> parasail CIGAR op index in "MIDNSHP=XB" ('='=7, 'X'=8,
# 'I'=1, 'D'=2); OP_NONE maps to 0 but is never encoded (stripped)
_OP_TO_CIGAR = np.array([0, 7, 8, 1, 2], dtype=np.uint32)
_ST_H, _ST_E, _ST_F, _ST_DONE = 0, 1, 2, 3

_WALK_JIT = {}


def device_walk(trace, qidx, ridx, end_q, end_r, mode: str,
                free: tuple[bool, bool, bool, bool]):
    """Walk every pair's trace back from its end cell, on device.

    trace: (B, Qp, Rp) int8 flag plane (device or host array)
    qidx:  (B or 1, Qp) int32 query letter indices (padded rows = -1)
    ridx:  (B, Rp) int32 reference letter indices
    end_q/end_r: (B,) end coordinates (kernel scalars)

    Returns (ops, beg_q, beg_r): ops is (B, Qp+Rp) uint8 opcodes in
    BACKWARD order (step 0 = last alignment column), zero-padded after
    the walk ends; beg_* are the alignment begin coordinates.
    """
    import jax

    B, Qp, Rp = trace.shape
    local = mode == "sw"
    qb, _qe, db, _de = (True,) * 4 if local else free
    key = (Qp, Rp, local, qb, db)
    fn = _WALK_JIT.get(key)
    if fn is None:
        fn = _WALK_JIT[key] = jax.jit(
            lambda t, q, r, ei, ej: _walk_impl(
                t, q, r, ei, ej, Qp, Rp, local, qb, db))
    return fn(trace, qidx, ridx, end_q, end_r)


def _walk_impl(trace, qidx, ridx, end_q, end_r, Qp, Rp, local, qb, db):
    import jax
    import jax.numpy as jnp

    B = trace.shape[0]
    L = Qp + Rp
    tflat = trace.reshape(B, Qp * Rp)
    qidx = jnp.broadcast_to(qidx, (B, Qp))
    barange = jnp.arange(B)
    i32 = jnp.int32

    def step(carry, _):
        i, j, state = carry
        ii = jnp.clip(i, 0, Qp - 1)
        jj = jnp.clip(j, 0, Rp - 1)
        t = tflat[barange, ii * Rp + jj].astype(i32)
        qc = qidx[barange, ii]
        rc = ridx[barange, jj]

        h = t & TRACE_H_BITS
        diag = (h & TRACE_DIAG) != 0
        ins = (h & TRACE_INS) != 0
        del_ = (h & TRACE_DEL) != 0
        e_open = (t & TRACE_DIAG_E) != 0
        f_open = (t & TRACE_DIAG_F) != 0

        # H state (golden priority: diag, elif ins, elif del, else stop;
        # local ZERO stops before any of them)
        h_stop = (h == 0) if local else ~(diag | ins | del_)
        op_h = jnp.where(
            diag, jnp.where(qc == rc, OP_EQ, OP_X),
            jnp.where(ins, OP_I, jnp.where(del_, OP_D, OP_NONE)))
        ns_h = jnp.where(
            h_stop, _ST_DONE,
            jnp.where(diag, _ST_H,
                      jnp.where(ins, jnp.where(e_open, _ST_H, _ST_E),
                                jnp.where(f_open, _ST_H, _ST_F))))
        op_h = jnp.where(h_stop, OP_NONE, op_h)
        di_h = jnp.where(h_stop, 0, jnp.where(diag | ins, 1, 0))
        dj_h = jnp.where(h_stop, 0, jnp.where(diag | del_, 1, 0))

        # E state: emit I, continue E unless the E value opened from H
        op_e, ns_e, di_e, dj_e = (
            jnp.full(B, OP_I, i32),
            jnp.where(e_open, _ST_H, _ST_E), jnp.ones(B, i32),
            jnp.zeros(B, i32))
        # F state: emit D, continue F unless the F value opened from H
        op_f, ns_f, di_f, dj_f = (
            jnp.full(B, OP_D, i32),
            jnp.where(f_open, _ST_H, _ST_F), jnp.zeros(B, i32),
            jnp.ones(B, i32))

        live = (state != _ST_DONE) & (i >= 0) & (j >= 0)
        op = jnp.where(state == _ST_H, op_h,
                       jnp.where(state == _ST_E, op_e, op_f))
        ns = jnp.where(state == _ST_H, ns_h,
                       jnp.where(state == _ST_E, ns_e, ns_f))
        di = jnp.where(state == _ST_H, di_h,
                       jnp.where(state == _ST_E, di_e, di_f))
        dj = jnp.where(state == _ST_H, dj_h,
                       jnp.where(state == _ST_E, dj_e, dj_f))

        # boundary runs once one index is exhausted (golden: penalized
        # leading gaps belong to the alignment; free ones are overhang)
        ins_tail = (state != _ST_DONE) & (i >= 0) & (j < 0) & (
            (not db) and (not local))
        del_tail = (state != _ST_DONE) & (j >= 0) & (i < 0) & (
            (not qb) and (not local))
        op = jnp.where(live, op,
                       jnp.where(ins_tail, OP_I,
                                 jnp.where(del_tail, OP_D, OP_NONE)))
        ns = jnp.where(live, ns,
                       jnp.where(ins_tail | del_tail, state, _ST_DONE))
        di = jnp.where(live, di, jnp.where(ins_tail, 1, 0))
        dj = jnp.where(live, dj, jnp.where(del_tail, 1, 0))

        nc = ((i - di).astype(i32), (j - dj).astype(i32), ns.astype(i32))
        return nc, op.astype(jnp.uint8)

    init = (jnp.asarray(end_q, i32), jnp.asarray(end_r, i32),
            jnp.zeros(B, i32))
    (fi, fj, _), ops = jax.lax.scan(step, init, None, length=L)
    return ops.T, fi + 1, fj + 1


def ops_to_runs(ops_row: np.ndarray, merge_m: bool = False) -> np.ndarray:
    """One pair's backward opcode row -> packed uint32 CIGAR runs
    ((len << 4) | op, parasail codec constants.py)."""
    n = int(np.count_nonzero(ops_row))
    if n == 0:
        return np.empty(0, np.uint32)
    fwd = ops_row[:n][::-1].astype(np.uint32)
    ops = _OP_TO_CIGAR[fwd]
    if merge_m:
        ops = np.where((ops == 7) | (ops == 8), np.uint32(0), ops)
    bounds = np.flatnonzero(np.diff(ops)) + 1
    starts = np.concatenate(([0], bounds))
    ends = np.concatenate((bounds, [n]))
    return ((ends - starts).astype(np.uint32) << 4) | ops[starts]


def ops_to_runs_flat(ops: np.ndarray, merge_m: bool = False
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Whole-batch run-length encode: (B, L) backward opcode rows ->
    (flat packed uint32 CIGAR runs, per-pair run counts), in ONE
    vectorized numpy pass.

    Pair b's runs are the ``counts[:b].sum() : counts[:b+1].sum()``
    slice of the flat array — identical values to per-pair
    ops_to_runs(row, merge_m).  The per-pair loop costs ~16 us/pair of
    numpy call overhead (8+ ms for a 512-pair batch, dwarfing the
    <1 ms of actual work), which matters on the align_cigars serving
    path.

    The native single-pass encoder (native/ptwalk.cc::pt_rle_ops,
    OpenMP) serves this when built — the numpy formulation below costs
    ~38 ms on a (4096, 320) batch (five full-array passes), the single
    C pass ~1-2 ms; the numpy path remains as the no-compiler fallback.
    """
    B, L = ops.shape
    if B == 0:
        return np.empty(0, np.uint32), np.empty(0, np.int64)
    from ..native import walker

    native = walker.rle_ops(ops, merge_m)
    if native is not None:
        return native
    ns = np.count_nonzero(ops, axis=1)          # walk emits a nonzero prefix
    k = np.arange(L)
    idx = ns[:, None] - 1 - k[None, :]          # reverse each prefix
    fwd = ops[np.arange(B)[:, None], np.clip(idx, 0, L - 1)]
    cig = _OP_TO_CIGAR[fwd.astype(np.uint32)]
    if merge_m:
        cig = np.where((cig == 7) | (cig == 8), np.uint32(0), cig)
    live = idx >= 0
    # run starts: first live column, plus every live op change
    change = np.empty((B, L), bool)
    change[:, 0] = live[:, 0]
    change[:, 1:] = (cig[:, 1:] != cig[:, :-1]) & live[:, 1:]
    sb, sk = np.nonzero(change)                 # sorted by (b, k)
    if len(sb) == 0:
        return np.empty(0, np.uint32), np.zeros(B, np.int64)
    nxt = np.empty(len(sk), sk.dtype)
    nxt[:-1] = sk[1:]
    nxt[-1] = 0
    same = np.empty(len(sb), bool)
    same[:-1] = sb[1:] == sb[:-1]
    same[-1] = False
    ends = np.where(same, nxt, ns[sb])
    packed = ((ends - sk).astype(np.uint32) << 4) | cig[sb, sk]
    return packed, np.bincount(sb, minlength=B)


def ops_to_runs_batch(ops: np.ndarray,
                      merge_m: bool = False) -> list[np.ndarray]:
    """Per-pair view of :func:`ops_to_runs_flat` (list of run arrays)."""
    packed, counts = ops_to_runs_flat(ops, merge_m)
    if len(counts) == 0:
        return []
    return np.split(packed, np.cumsum(counts)[:-1])
