"""Streaming executor: production serving over an unbounded pair stream.

The reference's serving story is one blocking FFI call per pair plus
user-managed threads (SURVEY.md §2.3); here it is a pipeline: submissions accumulate into length-binned buckets, each full
bucket dispatches ONE kernel launch asynchronously (jax dispatch
returns device futures immediately), and a background fetch thread
resolves buckets as the device finishes them — host packing of the next
bucket, device compute of the current one, and result fetch of the
previous one all overlap.

    stream = StreamingAligner(aligner, flush_size=2048)
    handles = [stream.submit(q, r) for q, r in pairs]
    for h in handles:          # resolves per bucket, in completion order
        h.result().get_score()

``Handle.result()`` dispatches only the bucket holding that pair (if it
has not filled yet) and blocks only on that bucket's completion — it
never flushes or waits for the rest of the stream.  ``flush()`` drains
everything (end-of-stream barrier).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field

import numpy as np

from ..utils.shapes import length_bucket
from . import dispatch


@dataclass
class Handle:
    """Future-like handle for one submitted pair."""

    _stream: "StreamingAligner"
    _seq: int
    _value: object = None
    _done: bool = False
    _event: threading.Event = field(default_factory=threading.Event)
    _bucket_key: tuple | None = None
    _error: BaseException | None = None

    def done(self) -> bool:
        return self._done

    def result(self, timeout: float | None = None):
        """This pair's Alignment.

        Dispatches the pair's own bucket if it is still accumulating,
        then waits for that bucket alone — other buckets keep streaming.
        """
        if not self._done:
            self._stream._ensure_dispatched(self)
            if not self._event.wait(timeout):
                raise TimeoutError("alignment result not ready")
        if self._error is not None:
            raise self._error
        return self._value


@dataclass
class _Bucket:
    qp: int
    rp: int
    queries: list = field(default_factory=list)
    references: list = field(default_factory=list)
    handles: list = field(default_factory=list)
    # one event shared by every bulk-submitted handle in the bucket —
    # the whole bucket resolves atomically, so per-pair events only add
    # allocation cost (measured: ~40% of a 16k-pair submit loop)
    event: threading.Event = field(default_factory=threading.Event)

    @property
    def size(self) -> int:
        return len(self.references)


class StreamingAligner:
    """Length-binned asynchronous batcher around an :class:`Aligner`.

    ``flush_size`` bounds pairs per kernel launch; ``max_cells`` bounds
    DP cells per launch (memory/latency).  Kernel dispatch happens on
    the submitting thread (keeping jax dispatch single-threaded); the
    daemon fetch thread only blocks on device results and builds
    Alignment objects.  Safe for one producer thread plus any number of
    threads calling ``Handle.result()``.
    """

    def __init__(self, aligner, flush_size: int = 2048,
                 max_cells: int = 1 << 28):
        self._aligner = aligner
        self._flush_size = flush_size
        self._max_cells = max_cells
        self._buckets: dict[tuple[int, int], _Bucket] = {}
        self._lock = threading.RLock()
        self._seq = 0
        self._inflight: list[threading.Event] = []
        self._undelivered = 0     # dispatched buckets not yet resolved
        self._queue: queue.SimpleQueue = queue.SimpleQueue()
        self._fetcher = threading.Thread(
            target=self._fetch_loop, daemon=True,
            name="parasail-stream-fetch")
        self._fetcher.start()

    def submit(self, query, reference) -> Handle:
        """Queue one pair; dispatches a kernel when its bucket fills."""
        a = self._aligner
        if not a.profile.is_null:
            query = None
        qlen = a.profile.query_len if query is None else len(query)
        key = (length_bucket(qlen), length_bucket(len(reference)))
        with self._lock:
            bucket = self._buckets.get(key)
            if bucket is None:
                bucket = self._buckets[key] = _Bucket(qp=key[0], rp=key[1])
            h = Handle(self, self._seq, _bucket_key=key)
            self._seq += 1
            bucket.queries.append(query)
            bucket.references.append(reference)
            bucket.handles.append(h)
            cells = bucket.size * bucket.qp * bucket.rp
            if bucket.size >= self._flush_size or cells >= self._max_cells:
                self._dispatch(key)
        return h

    def submit_many(self, queries, references) -> list[Handle]:
        """Bulk :meth:`submit`: one call for a whole list of pairs.

        Identical semantics to submitting each pair in a loop (same
        binning, same flush thresholds, handles in input order), but the
        per-pair host work is vectorized — numpy bucket assignment, one
        Event per bucket instead of per pair — cutting the submit-side
        overhead ~5x on 16k-pair streams (the per-pair loop alone costs
        ~200ms there, more than the device time of all its kernels).
        ``queries`` may be None when the aligner holds a profile.
        """
        a = self._aligner
        refs = list(references)
        n = len(refs)
        if not a.profile.is_null:
            queries = None
        if queries is None:
            if a.profile.is_null:
                from ..errors import QueryRequired

                raise QueryRequired(
                    "Query sequences are required without a profile.")
            qlist = None
            qlens = np.full(n, a.profile.query_len, np.int64)
        else:
            qlist = list(queries)
            qlens = np.fromiter((len(q) for q in qlist), np.int64, n)
        rlens = np.fromiter((len(r) for r in refs), np.int64, n)

        def vbucket(lens):
            u, inv = np.unique(lens, return_inverse=True)
            return np.array([length_bucket(int(x)) for x in u],
                            np.int64)[inv]

        qb = vbucket(qlens)
        rb = vbucket(rlens)
        gkey = qb << 32 | rb
        groups, ginv = np.unique(gkey, return_inverse=True)
        handles: list[Handle | None] = [None] * n
        with self._lock:
            full: list[_Bucket] = []
            for gi in range(len(groups)):
                idx = np.nonzero(ginv == gi)[0]
                key = (int(qb[idx[0]]), int(rb[idx[0]]))
                cell_cap = max(1, self._max_cells // (key[0] * key[1]))
                pos = 0
                while pos < len(idx):
                    bucket = self._buckets.get(key)
                    if bucket is None:
                        bucket = self._buckets[key] = _Bucket(
                            qp=key[0], rp=key[1])
                    room = max(1, min(self._flush_size, cell_cap)
                               - bucket.size)
                    take = idx[pos:pos + room]
                    pos += len(take)
                    ev = bucket.event
                    hs = [Handle(self, self._seq + int(i),
                                 _bucket_key=key, _event=ev)
                          for i in take]
                    for i, h in zip(take, hs):
                        handles[int(i)] = h
                    self._seq += len(take)
                    bucket.queries.extend(
                        [None] * len(take) if qlist is None else
                        (qlist[int(i)] for i in take))
                    bucket.references.extend(refs[int(i)] for i in take)
                    bucket.handles.extend(hs)
                    if (bucket.size >= self._flush_size
                            or bucket.size >= cell_cap):
                        # defer the launch: every full bucket of this
                        # bulk submit shares ONE concatenated plane
                        # upload below instead of one per bucket
                        full.append(self._buckets.pop(key))
            self._launch_group(full)
        return handles

    def _launch_group(self, buckets: list[_Bucket]) -> None:
        """Pack a group of buckets, commit their symbol planes with one
        upload, then launch each.  Caller holds the lock."""
        if not buckets:
            return
        prepped = [self._prepare(b) for b in buckets]
        dispatch.commit_batches([p[0] for p in prepped])
        for (batch, qlens, rlens), bucket in zip(prepped, buckets):
            self._launch(bucket, batch, qlens, rlens)

    def _ensure_dispatched(self, handle: Handle) -> None:
        """Dispatch the (partial) bucket containing ``handle`` if it has
        not launched yet — never touches other buckets."""
        with self._lock:
            key = handle._bucket_key
            bucket = self._buckets.get(key)
            if bucket is not None and handle in bucket.handles:
                self._dispatch(key)

    def _dispatch(self, key) -> None:
        """Launch one bucket asynchronously; results stay on device.

        Caller holds the lock.  The pending entry goes to the fetch
        thread, which resolves the bucket's handles when the device
        delivers.
        """
        bucket = self._buckets.pop(key)
        batch, qlens, rlens = self._prepare(bucket)
        dispatch.commit_batches([batch])
        self._launch(bucket, batch, qlens, rlens)

    def _prepare(self, bucket: _Bucket):
        """Host-pack one bucket into device-ready tensors (no upload)."""
        a = self._aligner
        queries = (None if bucket.queries[0] is None else bucket.queries)
        return a._pack(queries, bucket.references,
                       Qp=bucket.qp, Rp=bucket.rp)

    def _launch(self, bucket: _Bucket, batch, qlens, rlens) -> None:
        """Enqueue one packed bucket's kernel; caller holds the lock."""
        a = self._aligner
        pending = dispatch.execute(
            batch,
            gap_open=a.gap_open, gap_extend=a.gap_extend,
            mode=a.key.mode, free=a.key.free,
            outputs=a.key.outputs, width=a.key.width,
            fetch=False,
        ).start_transfer()   # overlap bucket transfers (one RTT, not N)
        done = threading.Event()
        self._inflight.append(done)
        self._undelivered += 1
        self._queue.put((pending, qlens, rlens, bucket.handles, done))

    def _fetch_loop(self) -> None:
        stop = False
        while not stop:
            item = self._queue.get()
            if item is None:
                return
            # Micro-batch: when MORE buckets are already dispatched
            # (burst submits, flush), wait briefly for their queue
            # entries and fetch the whole group with ONE fused
            # device->host transfer (dispatch.fetch_all), so a 2-bucket
            # flush pays one blocking transfer instead of two; with a
            # single in-flight bucket this never delays its fetch.
            items = [item]
            while len(items) < 16:
                # submit_many/flush dispatch whole bucket groups under
                # the stream lock, so by the time this thread acquires
                # it every bucket of the burst is already counted in
                # _undelivered — no time-based wait is needed, and a
                # lone in-flight bucket is never delayed (a partial
                # bucket still accumulating on the submit side must NOT
                # hold this fetch hostage: it may never dispatch)
                with self._lock:
                    more = self._undelivered > len(items)
                if not more:
                    break
                try:
                    nxt = self._queue.get(timeout=0.01)
                except queue.Empty:
                    continue
                if nxt is None:
                    stop = True
                    break
                items.append(nxt)
            try:
                hosts = dispatch.fetch_all([it[0] for it in items])
            except Exception:  # noqa: BLE001 — isolate failures per bucket
                hosts = [None] * len(items)
            for (pending, qlens, rlens, handles, done), host in zip(
                    items, hosts):
                try:
                    if host is None:
                        host = pending.fetch()
                    # columnar construction (~1.7 us/pair) — a per-pair
                    # _make_alignment loop costs ~13 us/pair, which at
                    # 16k pairs dwarfs the device kernels it postprocesses
                    alns = self._aligner._alignments_from(
                        host, qlens, rlens)
                    for h, a in zip(handles, alns):
                        h._value = a
                        h._done = True
                except Exception as e:  # propagate through result()
                    for h in handles:
                        h._value = None
                        h._error = e
                        h._done = True
                finally:
                    # fire events only after EVERY handle has its value —
                    # bulk-submitted handles share one bucket event; an
                    # early set() would wake a waiter whose slot is
                    # unfilled
                    for ev in {h._event for h in handles}:
                        ev.set()
                    done.set()
                    with self._lock:
                        self._undelivered -= 1

    def flush(self) -> None:
        """Dispatch every partial bucket and wait for all in-flight
        buckets to resolve (end-of-stream barrier)."""
        with self._lock:
            partial = [self._buckets.pop(key) for key in list(self._buckets)
                       if self._buckets[key].size]
            self._buckets.clear()
            self._launch_group(partial)
            inflight, self._inflight = self._inflight, []
        for ev in inflight:
            ev.wait()

    def close(self) -> None:
        """Drain and stop the fetch thread."""
        self.flush()
        self._queue.put(None)
        self._fetcher.join(timeout=10)

    def __enter__(self) -> "StreamingAligner":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
