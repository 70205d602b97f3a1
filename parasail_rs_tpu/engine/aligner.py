"""Aligner and AlignerBuilder: configuration -> kernel dispatch.

The reference accumulates configuration as strings, composes a parasail C
function name, and resolves a function pointer at build() time
(src/aligner/mod.rs:67-370).  Here configuration resolves to a typed
:class:`~parasail_rs_tpu.ops.specs.KernelKey` and ``align`` dispatches a
batched jitted wavefront kernel; the per-pair FFI boundary of the
reference becomes a host->device batch boundary.

Config semantics preserved exactly (src/aligner/mod.rs:213-267):
``use_stats`` disables trace (with a warning); ``use_table`` silently
disables trace; ``use_trace`` disables table and stats (with warnings);
``use_last_rowcol`` overrides ``use_table``.
"""

from __future__ import annotations

import logging
import threading

import numpy as np

from ..errors import InteriorNulByte, NoBandwidth, NoTrace, QueryRequired
from ..golden.model import free_flags
from ..matrices import Matrix
from ..ops.specs import KernelKey
from ..utils import stages
from ..utils.gcpause import gc_pause
from . import dispatch
from .profile import Profile
from .result import Alignment, PairFields, SSWResult

log = logging.getLogger("parasail_rs_tpu")


def _as_bytes(x) -> bytes:
    b = x.encode() if isinstance(x, str) else bytes(x)
    if 0 in b:
        raise InteriorNulByte("sequence contains an interior NUL byte")
    return b


_CIGAR_FUSE = None


def _cigar_fuse():
    """Jitted (opcode rows, packed scalars, begin coords) -> one int32
    array so the walk paths pay a single device->host transfer
    (align_cigars / ssw_batch).  Opcodes (values 0-4) nibble-pack two
    per byte before the bitcast, halving the dominant payload."""
    global _CIGAR_FUSE
    if _CIGAR_FUSE is None:
        import jax
        import jax.numpy as jnp

        def fuse(ops, packed, bq, br, pad):
            if pad:
                ops = jnp.pad(ops, ((0, 0), (0, pad)))
            Bp = ops.shape[0]
            nib = ops[:, ::2] | (ops[:, 1::2] << 4)      # (Bp, Lp/2)
            words = jax.lax.bitcast_convert_type(
                nib.reshape(Bp, -1, 4), jnp.int32)       # (Bp, Lp/8)
            return jnp.concatenate(
                [packed.astype(jnp.int32), bq[None].astype(jnp.int32),
                 br[None].astype(jnp.int32), words.T], axis=0)

        _CIGAR_FUSE = jax.jit(fuse, static_argnums=4)
    return _CIGAR_FUSE


def _unpack_nibbles(words: np.ndarray, B: int, L: int) -> np.ndarray:
    """(Lw, Bp) int32 rows from :func:`_cigar_fuse` -> (B, L) uint8
    opcode rows (inverse of the nibble pack)."""
    by = np.ascontiguousarray(words.T).view(np.uint8)    # (Bp, Lw*4)
    ops = np.empty((B, by.shape[1] * 2), np.uint8)
    ops[:, 0::2] = by[:B] & 0xF
    ops[:, 1::2] = by[:B] >> 4
    return ops[:, :L]


class AlignerBuilder:
    """Builder for :class:`Aligner` (reference: src/aligner/mod.rs:67-370).

    Defaults mirror the reference exactly (src/aligner/mod.rs:86-104):
    global (nw) mode, ``sat`` solution width, identity DNA matrix,
    gap_open = 0, gap_extend = 0 (note: the reference's doc comments claim
    5/2 but its code defaults to 0/0 — we follow the code), no profile,
    striped strategy, no stats/table/trace outputs.
    """

    def __init__(self):
        self._mode = "nw"
        self._solution_width = "sat"
        self._matrix = Matrix.default()
        self._gap_open = 0
        self._gap_extend = 0
        self._profile = Profile.default()
        self._allow_query_gaps: list[str] = []
        self._allow_ref_gaps: list[str] = []
        self._vec_strategy = "striped"
        self._use_stats = False
        self._use_table = ""          # "" | "table" | "rowcol"
        self._use_trace = False
        self._bandwidth: int | None = None

    # -- mode (src/aligner/mod.rs:108-123) -----------------------------------
    def global_(self) -> "AlignerBuilder":
        self._mode = "nw"
        return self

    def semi_global(self) -> "AlignerBuilder":
        self._mode = "sg"
        return self

    def local(self) -> "AlignerBuilder":
        self._mode = "sw"
        return self

    # -- width / matrix / gaps (src/aligner/mod.rs:127-154) ------------------
    def solution_width(self, solution_width: int | str) -> "AlignerBuilder":
        self._solution_width = str(solution_width)
        return self

    def matrix(self, matrix: Matrix) -> "AlignerBuilder":
        self._matrix = matrix
        return self

    def gap_open(self, gap_open: int) -> "AlignerBuilder":
        self._gap_open = int(gap_open)
        return self

    def gap_extend(self, gap_extend: int) -> "AlignerBuilder":
        self._gap_extend = int(gap_extend)
        return self

    # -- profile (src/aligner/mod.rs:157-160) --------------------------------
    def profile(self, profile: Profile) -> "AlignerBuilder":
        self._profile = profile
        return self

    # -- semi-global free ends (src/aligner/mod.rs:172-190) ------------------
    def allow_query_gaps(self, allow_gaps: list[str]) -> "AlignerBuilder":
        self._allow_query_gaps = list(allow_gaps)
        return self

    def allow_ref_gaps(self, allow_gaps: list[str]) -> "AlignerBuilder":
        self._allow_ref_gaps = list(allow_gaps)
        return self

    # -- strategy (src/aligner/mod.rs:193-208) -------------------------------
    def striped(self) -> "AlignerBuilder":
        self._vec_strategy = "striped"
        return self

    def scan(self) -> "AlignerBuilder":
        self._vec_strategy = "scan"
        return self

    def diag(self) -> "AlignerBuilder":
        self._vec_strategy = "diag"
        return self

    # -- outputs with mutual exclusion (src/aligner/mod.rs:213-267) ----------
    def use_stats(self) -> "AlignerBuilder":
        self._use_stats = True
        if self._use_trace:
            log.warning(
                "Warning: Traceback was enabled previously, but not supported "
                "with stats. Disabling traceback")
            self._use_trace = False
        return self

    def use_table(self) -> "AlignerBuilder":
        self._use_table = "table"
        if self._use_trace:
            self._use_trace = False
        return self

    def use_last_rowcol(self) -> "AlignerBuilder":
        self._use_table = "rowcol"
        return self

    def use_trace(self) -> "AlignerBuilder":
        self._use_trace = True
        if self._use_table:
            log.warning(
                "Warning: Table was enabled previously, but not supported "
                "with traceback. Disabling table")
            self._use_table = ""
        if self._use_stats:
            log.warning(
                "Warning: Stats were enabled previously, but not supported "
                "with traceback. Disabling stats")
            self._use_stats = False
        return self

    # -- banded (src/aligner/mod.rs:333-336) ---------------------------------
    def bandwidth(self, bandwidth: int) -> "AlignerBuilder":
        self._bandwidth = int(bandwidth)
        return self

    # -- build (src/aligner/mod.rs:339-369) ----------------------------------
    def build(self) -> "Aligner":
        profile = self._profile
        has_profile = not profile.is_null
        stats = profile.use_stats if has_profile else self._use_stats
        if self._use_trace:
            outputs = "trace"
        elif self._use_table == "table":
            outputs = "stats_table" if stats else "table"
        elif self._use_table == "rowcol":
            outputs = "stats_rowcol" if stats else "rowcol"
        elif stats:
            outputs = "stats"
        else:
            outputs = "score"
        key = KernelKey(
            mode=self._mode,
            free=free_flags(self._mode, self._allow_query_gaps, self._allow_ref_gaps),
            outputs=outputs,
            strategy=self._vec_strategy,
            profile=has_profile,
            width=self._solution_width,
        )
        matrix = profile.matrix if has_profile else self._matrix
        # The native C++ walker serves Aligner.cigars and the run-length
        # encoder behind align_cigars (walker.rle_ops).  Its
        # first _load() compiles the extension (a g++ subprocess); warm
        # it off-thread at build time so no align/align_cigars call
        # pays the compile inline (walker._load is lock-guarded +
        # cached, so concurrent builds cost one thread spawn).
        from ..native import walker

        threading.Thread(target=walker._load, daemon=True,
                         name="parasail-walker-warm").start()
        return Aligner(
            key=key,
            matrix=matrix,
            gap_open=self._gap_open,
            gap_extend=self._gap_extend,
            profile=profile,
            bandwidth=self._bandwidth,
        )


class Aligner:
    """Configured aligner (reference: src/aligner/mod.rs:372-535).

    Construct via ``Aligner.new()`` (returns a builder).  Instances are
    immutable and safe to share across threads — the reference's
    ``unsafe Send+Sync`` (src/aligner/mod.rs:533-535) becomes functional
    purity of the jitted dispatch here.
    """

    def __init__(self, key: KernelKey, matrix: Matrix, gap_open: int,
                 gap_extend: int, profile: Profile, bandwidth: int | None):
        self.key = key
        self.matrix = matrix
        self.gap_open = gap_open
        self.gap_extend = gap_extend
        self.profile = profile
        self.bandwidth = bandwidth
        self.vec_strategy = key.strategy
        # Tally of batches that fell off the kernel route, keyed
        # (route, reason).
        from collections import Counter

        self.route_counter: Counter = Counter()
        if matrix.approximate:
            log.warning(
                "Aligner built with synthesised builtin matrix %r — scores "
                "are NOT bit-exact vs parasail; register exact NCBI data "
                "(matrices.register_ncbi_dir / PT_NCBI_MATRICES) for "
                "parity", matrix.name)

    @property
    def matrix_approximate(self) -> bool:
        """True when the configured matrix is a synthesised builtin rather
        than verbatim NCBI data (see matrices.ncbi)."""
        return bool(self.matrix.approximate)

    @staticmethod
    def new() -> AlignerBuilder:
        return AlignerBuilder()

    # -- result construction helpers -----------------------------------------
    def _flags(self, saturated: bool, banded: bool = False) -> dict:
        key = self.key
        return {
            "nw": key.mode == "nw",
            "sg": key.mode == "sg",
            "sw": key.mode == "sw",
            "striped": not banded and key.strategy == "striped",
            "scan": not banded and key.strategy == "scan",
            "diag": not banded and key.strategy == "diag",
            "banded": banded,
            "blocked": False,
            "saturated": saturated,
            "stats": key.uses_stats,
            "table": key.outputs in ("table", "stats_table"),
            "stats_table": key.outputs == "stats_table",
            "rowcol": key.outputs in ("rowcol", "stats_rowcol"),
            "stats_rowcol": key.outputs == "stats_rowcol",
            "trace": key.outputs == "trace",
        }

    def _make_alignment(self, out: dict, b: int, qlen: int, rlen: int) -> Alignment:
        fields = dispatch.slice_pair(out, b, qlen, rlen)
        return Alignment(
            fields=fields,
            flags=self._flags(bool(fields.get("saturated", False))),
            query_len=qlen,
            ref_len=rlen,
            matrix=self.matrix,
            free=self.key.free,
            mode=self.key.mode,
        )

    # -- alignment (src/aligner/mod.rs:397-452) ------------------------------
    def align(self, query, reference) -> Alignment:
        """Align one pair.  With a profile set, pass ``query=None``."""
        return self.align_batch(
            None if query is None else [query], [reference])[0]

    def _pack(self, queries, references, Qp=None, Rp=None):
        if queries is None:
            if self.profile.is_null:
                raise QueryRequired(
                    "Query sequence is required for alignment without a profile.")
            return dispatch.pack_pairs(
                self.matrix, None, references, profile=self.profile,
                Qp=Qp, Rp=Rp)
        return dispatch.pack_pairs(self.matrix, queries, references,
                                   Qp=Qp, Rp=Rp)

    def _execute(self, batch, fetch=True):
        return dispatch.execute(
            batch,
            gap_open=self.gap_open, gap_extend=self.gap_extend,
            mode=self.key.mode, free=self.key.free,
            outputs=self.key.outputs, width=self.key.width, fetch=fetch,
            on_fallback=lambda route, reason:
                self.route_counter.update([(route, reason)]),
        )

    def _alignments_from(self, out, qlens, rlens):
        """Vectorized result-object construction.

        Per-pair field dicts cost ~1.7 us each — 14 ms for an 8192-pair
        batch, 3x the device kernel.  Instead every Alignment holds a
        :class:`PairFields` view over the SHARED columnar output arrays
        (scalars index on access; cell-sized planes slice on access) and
        one of two shared read-only flag dicts (they differ only in
        ``saturated``; every accessor only reads them).
        """
        n = len(rlens)
        big = {k: v for k, v in out.items()
               if k.endswith(("_table", "_row", "_col"))}
        cols = {k: np.asarray(v) for k, v in out.items() if k not in big}
        sat = cols.get("saturated")
        sat_l = ([False] * n if sat is None else
                 np.asarray(sat, bool).tolist())
        f_sat = self._flags(True)
        f_un = self._flags(False)
        mk, pf = Alignment, PairFields
        matrix, free, mode = self.matrix, self.key.free, self.key.mode
        with stages.stage("build"), gc_pause(n):
            return [
                mk(fields=pf(cols, big, b, qlens[b], rlens[b]),
                   flags=f_sat if sat_l[b] else f_un,
                   query_len=qlens[b], ref_len=rlens[b],
                   matrix=matrix, free=free, mode=mode)
                for b in range(n)
            ]

    def _run_packed(self, batch, qlens, rlens):
        return self._alignments_from(self._execute(batch), qlens, rlens)

    def align_batch(self, queries, references) -> list[Alignment]:
        """Batched alignment — the main device path.

        ``queries=None`` (profile mode) aligns the profile query against
        every reference; otherwise ``queries`` and ``references`` are
        parallel lists of byte sequences.  One kernel launch covers the
        whole batch (one padded shape); for mixed-length workloads use
        :meth:`align_many`, which length-bins first.
        """
        if len(references) == 0:
            return []
        if not self.profile.is_null:
            # parity: with a profile set the reference dispatches the
            # profile function and ignores any passed query
            # (src/aligner/mod.rs:431-449)
            queries = None
        return self._run_packed(*self._pack(queries, references))

    def align_many(self, queries, references,
                   max_cells: int | None = None) -> list[Alignment]:
        """Length-binned batched alignment (BASELINE config 5).

        Pairs are grouped by padded-shape bucket so a 100bp pair never
        pays a 10kbp tile (batch/scheduler.py); results return in input
        order.

        ``max_cells`` caps B*Qp*Rp per launch.  Default: 2^28 for
        cell-sized output classes (trace/tables keep a (B, Qp, Rp) plane
        in device memory per outstanding launch) and 2^33 for scalar
        classes, whose launches carry no cell-sized planes.
        """
        from ..batch import plan_bins

        refs = list(references)
        if not refs:
            return []
        if not self.profile.is_null:
            queries = None  # parity: profile takes precedence (see align_batch)
        if queries is None:
            if self.profile.is_null:
                raise QueryRequired(
                    "Query sequence is required for alignment without a profile.")
            qlens = [self.profile.query_len] * len(refs)
            qsel = lambda idx: None
        else:
            queries = list(queries)
            qlens = [len(q) for q in queries]
            qsel = lambda idx: [queries[i] for i in idx]
        rlens = [len(r) for r in refs]
        # Scalar-output classes carry no B-scaled cell-sized planes, so
        # ``max_cells`` does not shrink their launches below 128 pairs.
        # Cell-sized outputs (trace/tables) keep the cells cap as the
        # true device-memory bound.
        cell_sized = self.key.outputs in ("trace", "table", "stats_table")
        if max_cells is None:
            max_cells = (1 << 28) if cell_sized else (1 << 33)
        bins = plan_bins(qlens, rlens, max_cells=max_cells,
                         lane_quantum=1 if cell_sized else 128)
        # mixed-length workloads can hit dozens of shape buckets; every
        # launch costs host dispatch time, which can dwarf a nearly-empty
        # bin's kernel — merge down to a handful, trading padded cells
        # for launches (batch/scheduler.merge_bins)
        from ..batch import merge_bins

        bins = merge_bins(bins, max_launches=16 if cell_sized else 8,
                          max_cells=max_cells)
        results: list[Alignment | None] = [None] * len(refs)
        # dispatch every bin before fetching any: device compute of bin k
        # overlaps host packing of bin k+1 and the fetches at the end.
        # Cell-sized outputs fetch per bin instead — every outstanding
        # bin keeps a (B, Qp, Rp)-sized plane live on HBM, and N bins
        # near the per-batch gate would otherwise accumulate N of them.
        packed = []
        for bin_ in bins:
            idx = bin_.indices
            batch, bql, brl = self._pack(
                qsel(idx), [refs[i] for i in idx], Qp=bin_.qp, Rp=bin_.rp)
            packed.append((idx, batch, bql, brl))
        # ONE concatenated plane upload for every bin
        dispatch.commit_batches([b for _, b, _, _ in packed])
        pending = [(idx, self._execute(batch, fetch=cell_sized), bql, brl)
                   for idx, batch, bql, brl in packed]
        # scalar outputs: ONE combined device->host transfer for every
        # bin (dispatch.fetch_all) instead of one round-trip per bin
        outs = (None if cell_sized else
                dispatch.fetch_all([p for _, p, _, _ in pending]))
        for k, (idx, pend, bql, brl) in enumerate(pending):
            out = pend if cell_sized else outs[k]
            sub = self._alignments_from(out, bql, brl)
            for i, aln in zip(idx, sub):
                results[i] = aln
        return results

    def cigars(self, alignments, queries, references) -> list[str]:
        """Batched CIGAR extraction over trace results.

        The same strings as ``a.get_cigar(q, r)`` per pair, but ONE
        native batch walk (OpenMP over pairs, native/ptwalk.cc) instead
        of a per-pair FFI round-trip — ~20x less host time on large
        batches.  Falls back to the per-pair path when the native walker
        is unavailable.
        """
        from ..constants import cigar_runs_string
        from ..golden.model import free_flags
        from ..native import walker

        alignments = list(alignments)
        if not alignments:
            return []
        if not alignments[0].is_trace():
            raise NoTrace("cigars()")
        mode = self.key.mode
        free = self.key.free if mode == "sg" else free_flags(mode)
        qb, _, db, _ = free
        walked = walker.walk_batch(
            [a.fields["trace_table"] for a in alignments],
            queries, references,
            [a.get_end_query() for a in alignments],
            [a.get_end_ref() for a in alignments],
            local=mode == "sw", qb=qb, db=db)
        if walked is None:
            return [a.get_cigar(q, r)
                    for a, q, r in zip(alignments, queries, references)]
        return [cigar_runs_string(packed) for packed, _bq, _br in walked]

    def align_cigars(self, queries, references):
        """Batched alignment + CIGAR extraction with the DEVICE walk —
        the transfer-light CIGAR serving path (an extension of the
        reference API).

        Covers the same user intent as ``align`` + ``get_cigar`` per
        pair (reference: parasail_result_get_cigar,
        src/alignment/mod.rs:390-419) but never ships the (B, Qp, Rp)
        trace plane to the host: the trace kernel's flag plane stays on
        device, a batched ``lax.scan`` walks every pair back from its
        end cell (ops/trace_walk.py, bit-identical to the golden walk),
        and the host fetches only B*(Qp+Rp) opcode bytes (~80x less
        than the plane) plus the usual packed scalars.

        Returns ``(alignments, cigars)``: score-class ``Alignment``
        objects (score / end coordinates; no trace table is
        materialized, so ``is_trace()`` is False) and the CIGAR string
        per pair, identical to ``cigars()`` on a trace-enabled aligner.

        Mixed-length inputs are length-binned like :meth:`align_many`
        (trace planes are cell-sized, so one tile for a 100bp pair in a
        2kbp batch would waste 99% of its cells); results return in
        input order.
        """
        refs = [_as_bytes(r) for r in references]
        if not refs:
            return [], []
        if not self.profile.is_null:
            queries = None
            qseqs = [self.profile.query] * len(refs)
        else:
            queries = [_as_bytes(q) for q in queries]
            qseqs = queries
        # result objects are score-class (no trace plane materializes)
        res_key = KernelKey(mode=self.key.mode, free=self.key.free,
                            outputs="score", strategy=self.key.strategy,
                            profile=not self.profile.is_null,
                            width=self.key.width)
        res_al = self if self.key == res_key else Aligner(
            key=res_key, matrix=self.matrix, gap_open=self.gap_open,
            gap_extend=self.gap_extend, profile=self.profile,
            bandwidth=None)
        n = len(refs)
        qlens_all = ([self.profile.query_len] * n if queries is None
                     else [len(q) for q in queries])
        from ..batch import merge_bins, plan_bins

        bins = merge_bins(
            plan_bins(qlens_all, [len(r) for r in refs],
                      max_cells=1 << 28, lane_quantum=1),
            max_launches=16, max_cells=1 << 28)
        if len(bins) == 1:
            return self._align_cigars_shape(
                queries, refs, qseqs, res_al, bins[0].qp, bins[0].rp)
        alns: list = [None] * n
        cigs: list = [None] * n
        for bin_ in bins:
            idx = bin_.indices
            a, c = self._align_cigars_shape(
                None if queries is None else [queries[i] for i in idx],
                [refs[i] for i in idx], [qseqs[i] for i in idx],
                res_al, bin_.qp, bin_.rp)
            for k, i in enumerate(idx):
                alns[i] = a[k]
                cigs[i] = c[k]
        return alns, cigs

    # pairs per device-walk launch: big batches split into sub-launches
    # whose upload/kernel/walk/fuse enqueue BEFORE any fetch blocks, so
    # chunk k's transfers overlap chunk k+1's device compute
    _CIGAR_CHUNK = 512

    def _align_cigars_shape(self, queries, refs, qseqs, res_al, Qp, Rp):
        """One shape bin of :meth:`align_cigars`."""
        from ..constants import cigar_strings_batch
        from ..ops.trace_walk import ops_to_runs_flat

        n = len(refs)
        CH = self._CIGAR_CHUNK
        spans = ([slice(0, n)] if n <= CH else
                 [slice(i, min(i + CH, n)) for i in range(0, n, CH)])
        sl0 = spans[0]
        batch0, qlens0, rlens0 = self._pack(
            None if queries is None else queries[sl0], refs[sl0],
            Qp=Qp, Rp=Rp)
        packed = [(sl0, batch0, qlens0, rlens0)]
        for sl in spans[1:]:
            batch, qlens, rlens = self._pack(
                None if queries is None else queries[sl], refs[sl],
                Qp=Qp, Rp=Rp)
            packed.append((sl, batch, qlens, rlens))
        qseq = None if self.profile.is_null else self.profile.query
        states = [(qlens, rlens, batch,
                   self._device_trace_walk_enqueue(batch, qseq=qseq))
                  for _sl, batch, qlens, rlens in packed]
        alns_all, cigs_all = [], []
        for qlens, rlens, batch, st in states:
            out, ops_host, _bq, _br = self._device_trace_walk_fetch(st)
            alns_all.extend(res_al._alignments_from(out, qlens, rlens))
            # gc_pause: the string build allocates ~30 gc-tracked
            # objects per pair; an untimely cyclic collection over the
            # just-built Alignment set would cost more than the build
            with stages.stage("encode"), gc_pause(batch.size * 8):
                cigs_all.extend(cigar_strings_batch(
                    *ops_to_runs_flat(ops_host[:batch.size])))
        return alns_all, cigs_all

    def _device_trace_walk(self, batch, qseq: bytes | None = None):
        """Trace kernel + device traceback walk with ONE fused fetch.

        Returns (scalars dict, ops rows (B, Qp+Rp) uint8 backward,
        beg_query (B,), beg_ref (B,)).  The trace flag plane never
        leaves the device; the host receives the kernel scalars, the
        walk's begin coordinates, and the compact opcode rows in a
        single device->host transfer.

        The '=' vs 'X' decision follows golden walk_trace's RAW byte
        comparison — mapped indices fold case and wildcards, which is
        the `matches` stat's semantics, not the CIGAR's — so the walk
        receives the packed byte planes when the batch carries them
        (``qseq`` supplies the query bytes for shared-profile batches).
        """
        st = self._device_trace_walk_enqueue(batch, qseq=qseq)
        return self._device_trace_walk_fetch(st)

    def _device_trace_walk_enqueue(self, batch, qseq: bytes | None = None):
        """Enqueue phase of :meth:`_device_trace_walk`: upload, trace
        kernel, device walk, fuse, and the async d2h copy — returns an
        opaque state for :meth:`_device_trace_walk_fetch` without
        blocking, so several sub-batches can be in flight at once."""
        from ..ops.trace_walk import device_walk

        batch.to_device()   # kernel + walk share one plane upload
        pend = dispatch.execute(
            batch, gap_open=self.gap_open, gap_extend=self.gap_extend,
            mode=self.key.mode, free=self.key.free, outputs="trace",
            width=self.key.width, fetch=False,
            on_fallback=lambda route, reason:
                self.route_counter.update([(route, reason)]),
        )
        if pend._packed is not None:
            names, packed, big, B = pend._packed
            trace_dev = big["trace_table"]
            eq_dev = packed[names.index("end_query")]
            er_dev = packed[names.index("end_ref")]
        else:
            dev = pend._device_out
            trace_dev = dev["trace_table"]
            eq_dev = dev["end_query"]
            er_dev = dev["end_ref"]
            B = batch.size
        # symbol planes for the '=' decision: raw bytes when available
        qi, ri = batch.qidx, batch.ridx
        if batch.rbytes is not None:
            if batch.qbytes is not None:
                qi, ri = batch.qbytes, batch.rbytes
            elif qseq is not None:
                qarr = np.zeros((1, batch.qp), np.uint8)
                qb_ = np.frombuffer(qseq, np.uint8)
                qarr[0, :len(qb_)] = qb_
                qi, ri = qarr, batch.rbytes
        ops_dev, bq_dev, br_dev = device_walk(
            trace_dev, qi, ri, eq_dev, er_dev,
            self.key.mode, self.key.free)
        L = ops_dev.shape[1]
        if pend._packed is not None:
            # ONE device->host transfer: nibble-pack the opcode rows,
            # bitcast to int32 words, concatenate with scalars + begin
            # coords
            Lp = (L + 7) // 8 * 8
            fused = _cigar_fuse()(ops_dev, packed, bq_dev, br_dev,
                                  Lp - L)
            copy = getattr(fused, "copy_to_host_async", None)
            if copy is not None:
                copy()
            return ("fused", names, fused, B, L)
        prefetch = [v for k, v in dev.items() if k != "trace_table"]
        for a in (*prefetch, ops_dev, bq_dev, br_dev):
            copy = getattr(a, "copy_to_host_async", None)
            if copy is not None:
                copy()
        return ("raw", dev, ops_dev, bq_dev, br_dev, B)

    def _device_trace_walk_fetch(self, st):
        """Blocking phase of :meth:`_device_trace_walk`: fetch the fused
        payload and unpack (scalars dict, ops rows, beg_q, beg_r)."""
        if st[0] == "fused":
            _tag, names, fused, B, L = st
            with stages.stage("fetch"):
                host = np.asarray(fused)
            nn = len(names)
            out = dispatch._unpack_scalars(names, host[:nn], {}, B)
            bq, br = host[nn, :B], host[nn + 1, :B]
            ops_host = _unpack_nibbles(host[nn + 2:], B, L)
        else:
            _tag, dev, ops_dev, bq_dev, br_dev, B = st
            with stages.stage("fetch"):
                ops_host = np.asarray(ops_dev)[:B]
                bq = np.asarray(bq_dev)[:B]
                br = np.asarray(br_dev)[:B]
                out = {k: np.asarray(v)[:B] for k, v in dev.items()
                       if k != "trace_table"}
        return out, ops_host, bq, br

    # -- banded global NW (src/aligner/mod.rs:457-489) -----------------------
    def banded_nw(self, query, reference) -> Alignment:
        """Banded global alignment (reference -> parasail_nw_banded).

        Like the reference's, this path is score-only (no tables/trace) and
        requires ``bandwidth`` to have been set at build time.  Cells with
        ``|i - j| > bandwidth`` are excluded from the DP.  Unlike the
        reference's scalar C kernel, this runs the batched banded wavefront
        on the device (``banded_nw_batch`` exposes the batch form).
        """
        return self.banded_nw_batch([query], [reference])[0]

    def banded_nw_batch(self, queries, references) -> list[Alignment]:
        """Batched banded global alignment (an extension of the
        reference API)."""
        if self.bandwidth is None:
            raise NoBandwidth(
                "banded_nw() requires .bandwidth() on the builder")
        batch, qlens, rlens = self._pack(queries, references)
        out = dispatch._wavefront_exec(
            batch, gap_open=self.gap_open, gap_extend=self.gap_extend,
            mode="nw", free=(False,) * 4, outputs="score", width="32",
            banded=True, bandwidth=self.bandwidth,
        )
        out = {k: np.asarray(v) for k, v in out.items()}
        results = []
        for b in range(len(rlens)):
            fields = dispatch.slice_pair(out, b, qlens[b], rlens[b])
            flags = self._flags(False, banded=True)
            flags.update({"nw": True, "sg": False, "sw": False})
            results.append(Alignment(
                fields=fields, flags=flags,
                query_len=qlens[b], ref_len=rlens[b],
                matrix=self.matrix, free=(False,) * 4, mode="nw",
            ))
        return results

    # -- SSW emulation (src/aligner/mod.rs:492-529) --------------------------
    def ssw(self, query, reference) -> SSWResult:
        """Striped Smith-Waterman with start coordinates + raw CIGAR.

        Always local regardless of the configured mode (parasail_ssw is an
        SW kernel); uses this aligner's matrix and gap penalties.  The
        profile-based variant is unimplemented in the reference (panics,
        src/aligner/mod.rs:512-526); here it works when a profile is set
        and ``query=None``.
        """
        return self.ssw_batch(
            None if query is None else [query], [reference])[0]

    def ssw_batch(self, queries, references,
                  windowed: bool | None = None) -> list[SSWResult]:
        """Batched SSW (an extension of the reference API): one trace
        launch + one batched device CIGAR walk for the whole set.

        With a profile set and ``queries=None`` the profile's precomputed
        tensors drive the batch directly (the amortization
        ``parasail_ssw_init`` exists for, src/profile/mod.rs:337-358) and
        its ``score_size`` knob is honored: 0 = 8-bit mode — a pair whose
        8-bit lanes would saturate reports the capped ``score1 = 255``
        exactly as the SSW library does; 1/2 = 16-bit (or 8-then-16
        retry), capping at 65535.  ``parasail_ssw`` without a profile
        behaves as score_size 2 (src/alignment/mod.rs:507-544).

        ``windowed`` switches to the long-pair three-pass pipeline
        (score -> reversed score for begins -> window-trace for the
        CIGAR): flag memory is O(alignment window), not O(qlen*rlen),
        so arbitrarily long references stay on the fast device route.
        None (default) auto-enables it when the full flag plane would
        exceed 4 GiB.  The same technique the
        SSW library documents for long targets; CIGARs may differ from
        the one-pass walk only in tie-broken op order (scores and spans
        are identical — pinned by the re-scoring invariant test).
        """
        from ..ops.trace_walk import ops_to_runs_batch

        refs = [_as_bytes(r) for r in references]
        use_profile = queries is None
        if use_profile:
            if self.profile.is_null:
                raise QueryRequired(
                    "Query sequence is required for SSW alignment for now.")
            qs = [self.profile.query] * len(refs)
        else:
            qs = [_as_bytes(q) for q in queries]
        score_size = self.profile.score_size if use_profile else None
        if windowed is None:
            from ..utils.shapes import length_bucket

            Qp = length_bucket(max((len(q) for q in qs), default=1))
            Rp = length_bucket(max((len(r) for r in refs), default=1))
            windowed = len(refs) * Qp * Rp > 4 << 30
        if windowed:
            return self._ssw_windowed(qs, refs, use_profile, score_size)
        sw = Aligner(
            key=KernelKey(mode="sw", free=(True,) * 4, outputs="trace",
                          strategy="striped", profile=use_profile,
                          width="sat"),
            matrix=self.matrix, gap_open=self.gap_open,
            gap_extend=self.gap_extend,
            profile=self.profile if use_profile else Profile.default(),
            bandwidth=None,
        )
        batch, qlens, rlens = sw._pack(None if use_profile else qs, refs)
        # device walk: begins + merged-M CIGAR runs without ever
        # shipping the flag plane (same path as align_cigars)
        out, ops_host, bqs, brs = sw._device_trace_walk(
            batch, qseq=self.profile.query if use_profile else None)
        runs_all = ops_to_runs_batch(ops_host[:batch.size], merge_m=True)
        promoted = np.asarray(
            out.get("promoted", np.zeros(batch.size, bool)))
        results = []
        for k in range(batch.size):
            if score_size == 0 and bool(promoted[k]):
                # 8-bit-only mode: a saturated 8-bit lane reports the
                # SSW-library cap, not the exact wider score
                score1 = 255
            elif score_size == 0:
                score1 = min(int(out["score"][k]), 255)
            else:
                score1 = min(int(out["score"][k]), 0xFFFF)
            results.append(SSWResult(
                score1=score1,
                ref_begin1=int(brs[k]),
                ref_end1=int(out["end_ref"][k]),
                read_begin1=int(bqs[k]),
                read_end1=int(out["end_query"][k]),
                _cigar=runs_all[k],
            ))
        return results

    def _ssw_windowed(self, qs, refs, use_profile, score_size):
        """Three-pass long-pair SSW (see ssw_batch docstring).

        1. SW score pass over the full pairs -> score + end coords.
        2. SW score pass over the REVERSED prefixes q[:eq+1] / r[:er+1]
           -> its end coords are the begin coords (the SSW library's own
           begin-location technique).
        3. Global (NW) trace pass over just the [begin..end] windows —
           the optimal local path spans its window exactly, so its CIGAR
           is a max-score global alignment of the windows.  Flag memory
           is O(window), never O(qlen*rlen).
        """
        def sub(outputs, mode, profile):
            free = (True,) * 4 if mode == "sw" else (False,) * 4
            return Aligner(
                key=KernelKey(mode=mode, free=free, outputs=outputs,
                              strategy="striped", profile=profile,
                              width="sat"),
                matrix=self.matrix, gap_open=self.gap_open,
                gap_extend=self.gap_extend,
                profile=self.profile if profile else Profile.default(),
                bandwidth=None)

        n = len(refs)
        a1 = sub("score", "sw", use_profile).align_many(
            None if use_profile else qs, refs)
        scores = [a.get_score() for a in a1]
        eqs = [a.get_end_query() for a in a1]
        ers = [a.get_end_ref() for a in a1]
        promoted = [bool(a.fields.get("promoted", False)) for a in a1]

        live = [k for k in range(n) if scores[k] > 0]
        bqs = [0] * n
        brs = [0] * n
        cigars: list[np.ndarray] = [np.empty(0, np.uint32)] * n
        if live:
            # pass 2: begins from the reversed-prefix ends
            a2 = sub("score", "sw", False).align_many(
                [qs[k][:eqs[k] + 1][::-1] for k in live],
                [refs[k][:ers[k] + 1][::-1] for k in live])
            for k, a in zip(live, a2):
                bqs[k] = eqs[k] - a.get_end_query()
                brs[k] = ers[k] - a.get_end_ref()
            # pass 3: window trace + device walk, binned by padded shape
            # (the flag plane never transfers)
            from ..batch import merge_bins, plan_bins
            from ..ops.trace_walk import ops_to_runs_batch

            qw = [qs[k][bqs[k]:eqs[k] + 1] for k in live]
            rw = [refs[k][brs[k]:ers[k] + 1] for k in live]
            nwal = sub("trace", "nw", False)
            bins = merge_bins(
                plan_bins([len(q) for q in qw], [len(r) for r in rw],
                          max_cells=1 << 28, lane_quantum=1),
                max_launches=16, max_cells=1 << 28)
            for bin_ in bins:
                idx = bin_.indices
                bq_ = [qw[i] for i in idx]
                br_ = [rw[i] for i in idx]
                batch, bql, brl = nwal._pack(bq_, br_, Qp=bin_.qp,
                                             Rp=bin_.rp)
                _, ops_host, _b, _r = nwal._device_trace_walk(batch)
                bruns = ops_to_runs_batch(ops_host[:len(idx)],
                                          merge_m=True)
                for k, i in enumerate(idx):
                    cigars[live[i]] = bruns[k]

        results = []
        for k in range(n):
            if score_size == 0 and promoted[k]:
                score1 = 255
            elif score_size == 0:
                score1 = min(scores[k], 255)
            else:
                score1 = min(scores[k], 0xFFFF)
            results.append(SSWResult(
                score1=score1,
                ref_begin1=brs[k], ref_end1=ers[k],
                read_begin1=bqs[k], read_end1=eqs[k],
                _cigar=cigars[k],
            ))
        return results
