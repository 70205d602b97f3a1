"""Host-side batch assembly and kernel dispatch.

The reference's hot path is one FFI call per pair
(src/aligner/mod.rs:397-452); here that call becomes: pack a batch of
pairs into padded device tensors, run ONE device fill over the whole
batch (the GPU kernel of ops/gpu_fill.py, or the XLA wavefront of
ops/wavefront.py), and fetch the per-pair results.  Length bucketing
(utils.shapes.length_bucket) keeps the number of compiled shapes small.

Width dispatch replaces parasail's 8->16 saturation retry ladder
(src/aligner/mod.rs:125-126): scores are computed exactly in int32 in a
single pass while the kernel *detects* which pairs would have overflowed
8/16-bit lanes, so no retry run is ever needed — only the flag is reported
(``Alignment.is_saturated``, src/alignment/mod.rs:436-440).
"""

from __future__ import annotations

import logging
from collections import Counter

import numpy as np

from ..ops.wavefront import wavefront_align
from ..utils import stages
from ..utils.gcpause import gc_pause
from ..utils.shapes import length_bucket

log = logging.getLogger("parasail_rs_tpu")

# Global tally of dispatch routing decisions, keyed (route, reason).
# Per-aligner tallies live on Aligner.route_counter; this one catches
# direct execute() callers too.  A batch landing off the kernel route
# should never be silent.
ROUTE_COUNTS: Counter = Counter()


class PairBatch:
    """Padded device-ready tensors for a batch of alignment pairs.

    For square matrices ``profile`` is None and ``table`` carries the
    (A, A) substitution table instead: the per-pair profile rows are pure
    redundancy (every pair gathers from the same table): the kernel
    gathers scores from the table itself, and the wavefront builds the
    rows on the DEVICE at dispatch, so the host never materializes or
    ships the (B, Qp, A) tensor.

    Batches built by :func:`pack_pairs` additionally carry the raw
    ``qbytes``/``rbytes`` (uint8) and the matrix ``mapper``: the kernel
    route ships THOSE (4x smaller than int32 indices) and encodes inside
    its fused jit, so a batch costs one device dispatch.  ``qidx`` /
    ``ridx`` encode lazily (cached) for the routes that want indices.
    """

    def __init__(self, profile, qidx, ridx, qlen, rlen, table=None,
                 qbytes=None, rbytes=None, mapper=None):
        self.profile = profile       # (B or 1, Qp, A) int32, or None
        self._qidx = qidx            # (B or 1, Qp) int32 (lazy if None)
        self._ridx = ridx            # (B, Rp) int32 (lazy if None)
        self.qlen = np.asarray(qlen)             # (B,) int32
        self.rlen = np.asarray(rlen)             # (B,) int32
        self.table = table           # (A, A) int32 when profile is None
        self.qbytes = qbytes         # (B, Qp) uint8 raw sequence bytes
        self.rbytes = rbytes         # (B, Rp) uint8
        self.mapper = mapper         # (256,) int32 byte -> index

    @property
    def qidx(self):
        if self._qidx is None:
            self._qidx = _device_encode(
                self.mapper, self.qbytes, self.qlen, -1)
        return self._qidx

    @property
    def ridx(self):
        if self._ridx is None:
            self._ridx = _device_encode(
                self.mapper, self.rbytes, self.rlen, 0)
        return self._ridx

    @property
    def size(self) -> int:
        return int(self.qlen.shape[0])

    @property
    def qp(self) -> int:
        src = self._qidx if self._qidx is not None else self.qbytes
        return int(src.shape[1])

    @property
    def rp(self) -> int:
        src = self._ridx if self._ridx is not None else self.rbytes
        return int(src.shape[1])

    @property
    def shared_query(self) -> bool:
        """True for profile-reuse batches (one query, broadcast)."""
        return self._qidx is not None and self._qidx.shape[0] == 1

    def to_device(self) -> "PairBatch":
        """Commit the symbol planes to the device ONCE, in place.

        Paths that feed the planes to MULTIPLE jits (trace kernel +
        device walk, or kernel + lazy ``qidx`` encode) would otherwise
        re-upload the same numpy arrays per call.  A committed jax array
        is reused by every consumer for free.
        """
        import jax

        qb, rb = self.qbytes, self.rbytes
        if (isinstance(qb, np.ndarray) and isinstance(rb, np.ndarray)
                and qb.shape[0] == rb.shape[0]):
            # one upload, sliced on device
            cat = jax.device_put(np.concatenate([qb, rb], axis=1))
            self.qbytes = cat[:, :qb.shape[1]]
            self.rbytes = cat[:, qb.shape[1]:]
            return self
        if isinstance(qb, np.ndarray):
            self.qbytes = jax.device_put(qb)
        if isinstance(rb, np.ndarray):
            self.rbytes = jax.device_put(rb)
        return self

    @property
    def score_values(self) -> np.ndarray:
        return self.table if self.table is not None else self.profile


def commit_batches(batches: list["PairBatch"]) -> None:
    """Commit many batches' symbol planes with ONE h2d upload.

    ``align_many`` launches one kernel per shape bin; a per-bin
    ``to_device()`` pays the fixed per-upload cost once per bin.
    Concatenating every bin's planes into one flat uint8 buffer costs
    one upload; the per-bin views are device-side slices.
    """
    import jax

    host = []
    for b in batches:
        for attr in ("qbytes", "rbytes"):
            v = getattr(b, attr)
            if isinstance(v, np.ndarray):
                host.append((b, attr, v))
    if not host:
        return
    if len({id(b) for b, _, _ in host}) == 1:
        # a single batch: to_device() already concatenates its planes
        host[0][0].to_device()
        return
    flat = np.concatenate([v.reshape(-1) for _, _, v in host])
    dev = jax.device_put(flat)
    off = 0
    for b, attr, v in host:
        n = v.size
        setattr(b, attr, dev[off:off + n].reshape(v.shape))
        off += n


def build_batch(
    prows_list: list[np.ndarray],
    qidx_list: list[np.ndarray],
    ridx_list: list[np.ndarray],
    Qp: int | None = None,
    Rp: int | None = None,
    shared_query: bool = False,
) -> PairBatch:
    """Pack per-pair (rows, qidx, ridx) into one padded batch.

    ``prows_list[b]`` is the (qlen_b, A) profile-row block of pair ``b``
    (see engine.profile.profile_rows); alphabet width A must agree across
    the batch (one matrix per batch, as in the reference Aligner).

    ``shared_query=True`` (profile reuse: one query vs many references)
    stores the profile/qidx once as (1, Qp, ...) — the kernels broadcast
    — so a 100k-reference batch ships kilobytes of query data, not
    gigabytes.
    """
    B = len(ridx_list)
    A = prows_list[0].shape[1]
    Qp = Qp or length_bucket(max(p.shape[0] for p in prows_list))
    Rp = Rp or length_bucket(max(len(r) for r in ridx_list))
    Bq = 1 if shared_query else B
    profile = np.zeros((Bq, Qp, A), dtype=np.int32)
    qidx = np.full((Bq, Qp), -1, dtype=np.int32)
    ridx = np.zeros((B, Rp), dtype=np.int32)
    qlen = np.zeros(B, dtype=np.int32)
    rlen = np.zeros(B, dtype=np.int32)
    for b, (prow, qi, ri) in enumerate(zip(prows_list, qidx_list, ridx_list)):
        ql, rl = prow.shape[0], len(ri)
        if b < Bq:
            profile[b, :ql] = prow
            # padded query lanes must never count as matches: point them
            # at an index (-1) that no reference index can take
            qidx[b, :ql] = qi
        ridx[b, :rl] = ri
        qlen[b], rlen[b] = ql, rl
    return PairBatch(profile=profile, qidx=qidx, ridx=ridx, qlen=qlen, rlen=rlen)


def _pack_side(seqs, P):
    """Sequences -> (padded (B, P') uint8, (B,) int32 lens, P').

    The native single-pass packer (native/packer.py: PyBytes header
    reads + memcpy) serves list[bytes] directly; anything else is
    normalized to bytes and retried, and the numpy join + masked-scatter
    formulation remains as the no-compiler fallback.
    """
    from ..errors import InteriorNulByte
    from ..native import packer

    packed = packer.pack_side(seqs, P, length_bucket)
    if packed is None:
        # normalize once (str/bytearray/etc -> bytes) and retry the fast
        # path; the normalized list also feeds the numpy fallback below
        seqs = [s.encode() if isinstance(s, str)
                else (s if type(s) is bytes else bytes(s)) for s in seqs]
        packed = packer.pack_side(seqs, P, length_bucket)
    if packed is not None:
        return packed
    B = len(seqs)
    joined = b"".join(seqs)
    if 0 in joined:
        raise InteriorNulByte("sequence contains an interior NUL byte")
    lens = np.fromiter((len(s) for s in seqs), np.int32, B)
    P = P or length_bucket(int(lens.max()) if B else 1)
    mask = np.arange(P)[None, :] < lens[:, None]
    padded = np.zeros((B, P), np.uint8)
    padded[mask] = np.frombuffer(joined, np.uint8)
    return padded, lens, P


def pack_pairs(
    matrix,
    queries,
    references,
    profile=None,
    Qp: int | None = None,
    Rp: int | None = None,
):
    """Vectorized byte-sequences -> PairBatch (the production host path).

    One native packing pass per side (or the numpy join + masked-scatter
    fallback) replaces the per-pair encode/pad loops.  ``profile`` set
    means profile reuse: query tensors stored once.

    Returns (batch, qlens list, rlens list).
    """
    B = len(references)
    with stages.stage("pack"), gc_pause(B):
        return _pack_pairs_inner(matrix, queries, references, profile,
                                 Qp, Rp, B)


def _pack_pairs_inner(matrix, queries, references, profile, Qp, Rp, B):
    rbytes, rlens, Rp = _pack_side(references, Rp)
    # mapper lookup runs ON DEVICE: the batch ships packed uint8 bytes
    # (4x less transfer) and the host never pays the gather.  The kernel
    # route encodes INSIDE its fused jit; PairBatch.ridx encodes lazily
    # for everyone else.
    qbytes = None

    if profile is not None:
        ql = profile.query_len
        Qp = Qp or length_bucket(ql)
        A = profile.rows.shape[1]
        prof = np.zeros((1, Qp, A), np.int32)
        prof[0, :ql] = profile.rows
        qidx = np.full((1, Qp), -1, np.int32)
        qidx[0, :ql] = profile.qidx
        qlens = np.full(B, ql, np.int32)
    else:
        if len(queries) != B:
            raise ValueError("queries and references must have equal length")
        qbytes, qlens, Qp = _pack_side(queries, Qp)
        # padded query lanes must never count as matches (fill -1);
        # encoding is lazy (PairBatch.qidx)
        qidx = None
        A = matrix.size
        if matrix.is_square:
            # Device-side profile: ship only qidx + the (A, A) table.
            prof = None
        else:
            # PSSM rows are position-indexed — identical for every pair,
            # so store them once; the kernels broadcast.
            rows = np.take(matrix.data, np.arange(Qp) % matrix.length,
                           axis=0).astype(np.int32, copy=False)
            prof = np.ascontiguousarray(rows)[None]
    batch = PairBatch(
        profile=prof, qidx=qidx, ridx=None,
        qlen=np.asarray(qlens), rlen=np.asarray(rlens),
        table=np.ascontiguousarray(matrix.data, dtype=np.int32)
        if prof is None else None,
        qbytes=qbytes, rbytes=rbytes,
        mapper=np.asarray(matrix.mapper, np.int32))
    return batch, qlens.tolist(), rlens.tolist()


_ENCODE_JIT = None


def _device_encode(mapper, bytes2d, lens, fill):
    """uint8 sequence bytes -> masked int32 indices, on device."""
    global _ENCODE_JIT
    import jax
    import jax.numpy as jnp

    if _ENCODE_JIT is None:
        @jax.jit
        def enc(mapper, b2d, lens, fill):
            mask = (jnp.arange(b2d.shape[1], dtype=jnp.int32)[None, :]
                    < lens[:, None])
            idx = jnp.take(mapper, b2d.astype(jnp.int32))
            return jnp.where(mask, idx, fill)

        _ENCODE_JIT = enc
    return _ENCODE_JIT(
        jnp.asarray(mapper, jnp.int32), bytes2d,
        jnp.asarray(lens, jnp.int32), jnp.asarray(fill, jnp.int32))


INT32_SAFE = (1 << 31) - 1


def width64_risk(batch: PairBatch, gap_open: int,
                 gap_extend: int) -> np.ndarray:
    """Indices of pairs whose worst-case |H| could exceed int32.

    Per-pair bound: |H| <= (max|s| + open + ext) * (qlen + rlen) — every
    DP step changes H by at most one substitution plus one gap term.
    Conservative (a pair under the bound can NEVER overflow int32), so
    the int32 kernels serve everything not flagged here and only flagged
    pairs pay the exact int64 host fill.
    """
    smax = int(np.abs(np.asarray(batch.score_values)).max())
    per = smax + abs(int(gap_open)) + abs(int(gap_extend))
    bound = per * (batch.qlen.astype(np.int64) +
                   batch.rlen.astype(np.int64))
    return np.nonzero(bound > INT32_SAFE)[0]


def _golden64_merge(out: dict, batch: PairBatch, idx: np.ndarray, *,
                    gap_open, gap_extend, mode, free, outputs) -> dict:
    """Overwrite the int32 kernel results of ``idx`` pairs with an exact
    int64 scalar golden fill (golden/model.py computes in int64).

    Scalar/table/rowcol planes are upcast to int64 so merged scores
    survive; trace flags stay int8 (flag encoding is width-free).
    """
    from ..golden import model as golden

    qidx_all = np.asarray(batch.qidx)
    ridx_all = np.asarray(batch.ridx)
    prof = None if batch.profile is None else np.asarray(batch.profile)
    table = None if batch.table is None else np.asarray(batch.table)
    # writable copies: kernel outputs can be read-only views of device
    # buffers; int planes upcast to int64 so merged scores survive
    out = {k: (np.array(v) if v.dtype == np.int8
               or k in ("saturated", "promoted")
               else v.astype(np.int64))
           for k, v in out.items()}
    stats_keys = ("matches", "similar", "length")
    for b in idx.tolist():
        ql, rl = int(batch.qlen[b]), int(batch.rlen[b])
        qi = qidx_all[0 if qidx_all.shape[0] == 1 else b, :ql]
        ri = ridx_all[b, :rl]
        if table is not None:
            sub = table[qi[:, None], ri[None, :]].astype(np.int64)
        else:
            p = prof[0 if prof.shape[0] == 1 else b, :ql]
            sub = p[np.arange(ql)[:, None], ri[None, :]].astype(np.int64)
        g = golden.align(sub, qi[:, None] == ri[None, :],
                         int(gap_open), int(gap_extend), mode, free)
        out["score"][b] = g.score
        out["end_query"][b] = g.end_query
        out["end_ref"][b] = g.end_ref
        if "saturated" in out:
            out["saturated"][b] = False     # int64 fill cannot saturate
        for k in stats_keys:
            if k in out:
                out[k][b] = getattr(g, k)
        for k in list(out):
            if k.endswith("_table") and k != "trace_table":
                out[k][b] = 0
                out[k][b, :ql, :rl] = getattr(g, k)
            elif k.endswith("_row"):
                out[k][b] = 0
                out[k][b, :rl] = getattr(g, k)
            elif k.endswith("_col"):
                out[k][b] = 0
                out[k][b, :ql] = getattr(g, k)
        if "trace_table" in out:
            out["trace_table"][b] = 0
            out["trace_table"][b, :ql, :rl] = g.trace_table
    return out


def execute(
    batch: PairBatch,
    *,
    gap_open: int,
    gap_extend: int,
    mode: str,
    free: tuple[bool, bool, bool, bool],
    outputs: str,
    width: str,
    fetch: bool = True,
    on_fallback=None,
) -> dict[str, np.ndarray]:
    """Run the device fill over a batch; fetch host numpy results.

    ``width`` follows the reference grammar {sat,8,16,32,64} (parasail's
    ``_64`` kernels: src/aligner/mod.rs:331).  64 runs the int32 kernels
    for every pair whose worst-case |H| bound fits int32 — the device
    fills compute in int32 — and pairs whose bound does
    not fit are re-filled exactly in int64 by the scalar golden model
    and merged back (:func:`width64_risk`).  Sane inputs never trip the
    bound, so the honest knob costs nothing in practice.

    ``on_fallback(route, reason)`` is invoked whenever the batch does not
    take the kernel route (it lands on the wavefront); the same event is
    logged and tallied in :data:`ROUTE_COUNTS`.  A device failure on
    either route raises.
    """
    from ..utils import profiling

    if width == "64":
        wide = width64_risk(batch, gap_open, gap_extend)
        if wide.size:
            log.warning(
                "width='64': %d pair(s) exceed the int32 score bound; "
                "re-filling them exactly in int64 on the host (scalar "
                "golden model)", wide.size)
            out = execute(batch, gap_open=gap_open, gap_extend=gap_extend,
                          mode=mode, free=free, outputs=outputs,
                          width="32", fetch=True, on_fallback=on_fallback)
            out = _golden64_merge(out, batch, wide, gap_open=gap_open,
                                  gap_extend=gap_extend, mode=mode,
                                  free=free, outputs=outputs)
            return out if fetch else PendingResult(device_out=out)
    kernel_width = {"64": "32"}.get(width, width)
    with profiling.trace_region(f"pt.execute.{mode}.{outputs}"):
        route, reason = plan_route(batch, outputs)
        ROUTE_COUNTS[(route, reason)] += 1
        if route == "kernel":
            return _execute_kernel(
                batch, gap_open=gap_open, gap_extend=gap_extend, mode=mode,
                free=free, width=kernel_width, outputs=outputs, fetch=fetch)
        log.info("batch (B=%d, Qp=%d, Rp=%d, %s/%s) routed to %s: %s",
                 batch.size, batch.qp, batch.rp, mode, outputs, route,
                 reason)
        if on_fallback is not None:
            on_fallback(route, reason)
        out = _wavefront_exec(
            batch, gap_open=gap_open, gap_extend=gap_extend, mode=mode,
            free=free, outputs=outputs, width=kernel_width)
        if not fetch:
            return PendingResult(device_out=dict(out))
        return {k: np.asarray(v) for k, v in out.items()}


_PROFILE_JIT = None


def _device_profile(profile, table, qidx):
    """Materialize the per-pair profile rows ON DEVICE when the batch
    carries only the square substitution table: an integer gather
    replaces a (B, Qp, A) host tensor (hundreds of MB for big batches).
    A gather keeps every score exact, where a float32 one-hot matmul may
    run in TF32 and round entries beyond +/-2048.

    The jitted builder is a module-level singleton, so a new batch does
    not retrace it.
    """
    if table is None:
        return profile
    global _PROFILE_JIT
    import jax
    import jax.numpy as jnp

    if _PROFILE_JIT is None:
        @jax.jit
        def build(table, qidx):
            return jnp.take(table, jnp.clip(qidx, 0, table.shape[0] - 1),
                            axis=0)

        _PROFILE_JIT = build
    return _PROFILE_JIT(jnp.asarray(table, jnp.int32), jnp.asarray(qidx))


def choose_route(outputs: str, qp: int, rp: int, *, banded: bool = False,
                 platform: str | None = None) -> tuple[str, str]:
    """("kernel" | "wavefront", reason) for a padded shape and output class.

    The GPU kernel (ops/gpu_fill.py) serves score, stats and trace for
    queries of up to ``gpu_fill.MAX_QP`` padded rows; everything else,
    and every batch on a backend without a GPU, runs the XLA wavefront.
    The reason is empty for "kernel".  ``dist.sharded`` shares this
    decision; ``platform`` defaults to the one backend probe,
    ``jax.default_backend()``.
    """
    import jax

    from ..ops import gpu_fill

    platform = platform or jax.default_backend()
    if platform != "gpu":
        return "wavefront", f"backend is {platform}, the kernel needs a GPU"
    if not gpu_fill.supports(outputs, qp, rp, banded):
        return "wavefront", (f"no kernel for {outputs} at {qp}x{rp}"
                             + (" banded" if banded else ""))
    return "kernel", ""


def plan_route(batch: PairBatch, outputs: str) -> tuple[str, str]:
    """Pick the execution route for a batch (see :func:`choose_route`).
    Every route is exact for every penalty pair, so the penalties do not
    enter the decision."""
    return choose_route(outputs, batch.qp, batch.rp)


def _plane_bytes(route: str, outputs: str, B: int, qp: int, rp: int) -> int:
    """Device bytes of the cell-sized planes a launch materializes."""
    per_cell = {"trace": 1, "table": 4, "stats_table": 16}.get(outputs, 0)
    if per_cell == 0:
        return 0
    cells = B * qp * rp
    if route == "kernel":
        # (Qp, Rp, B) plane + its (B, Qp, Rp) transpose
        return 2 * cells * per_cell
    # the scan stacks one (B, Qp) slab per anti-diagonal, then gathers
    # them into the (B, Qp, Rp) plane
    return (qp + rp - 1) * B * qp * per_cell + cells * per_cell


def device_memory_budget() -> int | None:
    """Bytes the first device may hold, or None when it reports none."""
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("bytes_limit")


def check_plane_budget(route: str, outputs: str, B: int, qp: int,
                       rp: int) -> None:
    """Refuse, before allocating, a launch whose cell-sized planes
    cannot fit the device.  Use ``Aligner.cigars`` on smaller batches or
    ``align_many`` (which bins by shape) for such workloads."""
    need = _plane_bytes(route, outputs, B, qp, rp)
    budget = device_memory_budget()
    if need and budget is not None and need > budget:
        raise MemoryError(
            f"{outputs} planes for {B} pairs at {qp}x{rp} on the {route} "
            f"route need {need} bytes; the device holds {budget}")


_KERNEL_JIT_CACHE: dict = {}


def _kernel_exec_fn(table_path, qbytes_path, rbytes_path, mode, free,
                    width, outputs, interpret):
    """One jitted function covering the whole device path of a kernel
    launch: byte->index encode (bytes paths ship raw uint8), the score
    offsets into the table or profile, and the kernel, whose per-pair
    scalars come back packed in one array (one fetch)."""
    key = (table_path, qbytes_path, rbytes_path, mode, free, width,
           outputs, interpret)
    if key in _KERNEL_JIT_CACHE:
        return _KERNEL_JIT_CACHE[key]
    import jax
    import jax.numpy as jnp

    from ..ops.gpu_fill import dp_fill

    def encode(mapper, raw, lens, fill):
        m = jnp.arange(raw.shape[1], dtype=jnp.int32)[None, :] < lens[:, None]
        return jnp.where(m, jnp.take(mapper, raw.astype(jnp.int32)), fill)

    def fn(sub, qarg, rarg, mapper, qlen, rlen, gaps):
        qidx = encode(mapper, qarg, qlen, -1) if qbytes_path else qarg
        ridx = encode(mapper, rarg, rlen, 0) if rbytes_path else rarg
        Qp = qidx.shape[1]
        A = sub.shape[-1]
        rows = jnp.arange(Qp, dtype=jnp.int32)[None, :]
        if table_path:
            qoff = jnp.clip(qidx, 0, A - 1) * A
        elif sub.shape[0] == 1:
            qoff = rows * A
        else:
            # per-pair profile rows: pair b's block starts at b * Qp * A
            qoff = (jnp.arange(sub.shape[0], dtype=jnp.int32)[:, None] * Qp
                    + rows) * A
        return dp_fill(sub, qoff, qidx, ridx, qlen, rlen, gaps, mode=mode,
                       free=free, outputs=outputs, width=width,
                       interpret=interpret)

    jitted = jax.jit(fn)
    _KERNEL_JIT_CACHE[key] = jitted
    return jitted


class PendingResult:
    """Device-side result of an asynchronous dispatch.

    Holds jax arrays (dispatch already enqueued); :meth:`fetch` blocks on
    the device and returns host numpy arrays.  The kernel route keeps
    its per-pair scalars packed in one array so fetch() pays a single
    transfer.
    """

    def __init__(self, device_out=None, packed_form=None):
        self._device_out = device_out          # dict of jax arrays
        self._packed = packed_form             # (names, packed, big, B)

    def start_transfer(self) -> "PendingResult":
        """Begin the device->host copy without blocking, so several
        results in flight (align_many bins, StreamingAligner buckets)
        overlap their transfers with each other and with device work."""
        arrays = ([self._packed[1], *self._packed[2].values()]
                  if self._packed is not None
                  else list(self._device_out.values()))
        for a in arrays:
            copy = getattr(a, "copy_to_host_async", None)
            if copy is not None:
                copy()
        return self

    def fetch(self) -> dict[str, np.ndarray]:
        with stages.stage("fetch"):
            if self._packed is not None:
                names, packed, big, B = self._packed
                return _unpack_scalars(names, np.asarray(packed), big, B)
            return {k: np.asarray(v) for k, v in self._device_out.items()}


def fetch_all(pendings: list["PendingResult"]) -> list[dict]:
    """Fetch many pending results with ONE device->host transfer.

    When every pending holds a packed scalar form with the same output
    names and no cell-sized planes (score/stats classes), their packed
    arrays concatenate device-side into one array.  Falls back to
    per-pending fetch for mixed or cell-sized results.
    """
    if len(pendings) > 1:
        forms = [p._packed for p in pendings]
        if all(f is not None and not f[2] and f[0] == forms[0][0]
               for f in forms):
            import jax.numpy as jnp

            names = forms[0][0]
            with stages.stage("fetch"):
                host = np.asarray(jnp.concatenate([f[1] for f in forms],
                                                  axis=1))
            outs = []
            off = 0
            for f in forms:
                bp = f[1].shape[1]
                outs.append(_unpack_scalars(
                    names, host[:, off:off + bp], {}, f[3]))
                off += bp
            return outs
    for p in pendings:          # mixed forms: at least overlap the copies
        p.start_transfer()
    return [p.fetch() for p in pendings]


def _unpack_scalars(names, packed, big, B):
    bools = ("saturated", "promoted")
    out = {k: (packed[i, :B] != 0 if k in bools else packed[i, :B])
           for i, k in enumerate(names)}
    for k, v in big.items():
        out[k] = np.asarray(v)[:B]
    return out


def kernel_step(batch, *, gap_open, gap_extend, mode, free, width,
                outputs="score", interpret=False):
    """(jitted fn, args) of a kernel-route launch: what
    :func:`_execute_kernel` calls, exposed so a benchmark can lower and
    compile the same step (``fn.lower(*args).compile()``)."""
    table_path = batch.table is not None
    qbytes_path = table_path and batch.qbytes is not None
    rbytes_path = batch.rbytes is not None
    fn = _kernel_exec_fn(table_path, qbytes_path, rbytes_path, mode, free,
                         width, outputs, interpret)
    mapper = (batch.mapper if (qbytes_path or rbytes_path)
              else np.zeros(256, np.int32))
    args = (batch.table if table_path else batch.profile,
            batch.qbytes if qbytes_path else batch.qidx,
            batch.rbytes if rbytes_path else batch.ridx,
            mapper, batch.qlen, batch.rlen,
            np.array([gap_open, gap_extend], np.int32))
    return fn, args


def _execute_kernel(batch, *, gap_open, gap_extend, mode, free, width,
                    outputs="score", fetch=True, interpret=False):
    """Run the GPU kernel route.  ``interpret=True`` (tests only) runs
    the kernel through the Pallas interpreter."""
    from ..ops.gpu_fill import scalar_names

    check_plane_budget("kernel", outputs, batch.size, batch.qp, batch.rp)
    fn, args = kernel_step(batch, gap_open=gap_open, gap_extend=gap_extend,
                           mode=mode, free=free, width=width,
                           outputs=outputs, interpret=interpret)
    with stages.stage("dispatch"):
        packed, big = fn(*args)
    names = scalar_names(width, outputs == "stats")
    pend = PendingResult(packed_form=(names, packed, big, batch.size))
    return pend.fetch() if fetch else pend


def _wavefront_exec(batch, *, gap_open, gap_extend, mode, free, outputs,
                    width, banded=False, bandwidth=0):
    """XLA wavefront execution (every output class, any shape)."""
    check_plane_budget("wavefront", outputs, batch.size, batch.qp, batch.rp)
    return wavefront_align(
        _device_profile(batch.profile, batch.table, batch.qidx),
        batch.qidx, batch.ridx, batch.qlen, batch.rlen,
        open_=np.int32(gap_open), ext=np.int32(gap_extend),
        mode=mode, free=free, outputs=outputs, width=width,
        banded=banded, bandwidth=np.int32(bandwidth or 0))


def slice_pair(out: dict, b: int, qlen: int, rlen: int) -> dict:
    """Extract pair ``b``'s results, cropped from padded to true lengths."""
    fields = {}
    for k, v in out.items():
        if k.endswith("_table"):
            fields[k] = v[b, :qlen, :rlen]
        elif k.endswith("_row"):
            fields[k] = v[b, :rlen]
        elif k.endswith("_col"):
            fields[k] = v[b, :qlen]
        else:
            fields[k] = v[b]
    return fields
