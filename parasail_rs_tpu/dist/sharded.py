"""Data-parallel sharded alignment over a device mesh.

The replacement for the reference's thread-level parallelism
(SURVEY.md §2.3: ``unsafe Send+Sync`` + ``Arc`` sharing,
src/aligner/mod.rs:533-535): a pair batch is sharded over the ``data``
axis of a 1-D mesh, every device runs the same fill on its shard via
``shard_map``, and per-pair outputs come back sharded the same way.
Profiles and matrices are tiny and replicated.

Routing is the single-device engine's decision
(engine.dispatch.choose_route), per shard: the GPU kernel
(ops/gpu_fill.py) where it applies, the XLA wavefront otherwise.  The
cards of one host reach each other all to all, so the mesh is a plain
1-D list of ``jax.devices()``.

Multi-host: ``jax.distributed.initialize`` (driven by the caller) makes
``jax.devices()`` span hosts; ``sharded_align`` is unchanged — the mesh
covers every device and only the batch scatter / result gather cross
the host boundary.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.wavefront import wavefront_align


def make_device_mesh(n_devices: int | None = None) -> Mesh:
    """A 1-D data-parallel mesh over the first ``n_devices`` devices."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return jax.make_mesh((len(devs),), ("data",), devices=devs)


def plan_sharded_route(*, outputs: str, Qp: int, Rp: int,
                       platform: str | None = None) -> str:
    """"kernel" or "wavefront" for a sharded batch: the engine's own
    route decision (engine.dispatch.choose_route)."""
    from ..engine.dispatch import choose_route

    return choose_route(outputs, Qp, Rp, platform=platform)[0]


@functools.lru_cache(maxsize=128)
def _sharded_fn(mesh: Mesh, mode: str, free, outputs: str, width: str,
                shared: bool, kernel: str, interpret: bool):
    """jit(shard_map(fill)) for one (mesh, config) combination, cached so
    repeated dispatches reuse the compiled executable."""
    from ..ops.gpu_fill import dp_fill, scalar_names
    from .seqpar import _shard_map

    axis = mesh.axis_names[0]

    def local(profile, qidx, ridx, qlen, rlen, open_, ext):
        if kernel == "kernel":
            Bq, Qp, A = profile.shape
            qoff = (jnp.arange(Bq, dtype=jnp.int32)[:, None] * Qp
                    + jnp.arange(Qp, dtype=jnp.int32)[None, :]) * A
            packed, big = dp_fill(
                profile, qoff, qidx, ridx, qlen, rlen,
                jnp.stack([open_, ext]), mode=mode, free=free,
                outputs=outputs, width=width, interpret=interpret)
            names = scalar_names(width, outputs == "stats")
            out = {k: packed[i] for i, k in enumerate(names)}
            for k in ("saturated", "promoted"):
                if k in out:
                    out[k] = out[k] != 0
            out.update(big)
            return out
        return wavefront_align(
            profile, qidx, ridx, qlen, rlen, open_=open_, ext=ext,
            mode=mode, free=free, outputs=outputs, width=width)

    qspec = P() if shared else P(axis)
    fn = _shard_map(
        local, mesh,
        in_specs=(qspec, qspec, P(axis), P(axis), P(axis), P(), P()),
        out_specs=P(axis),
    )
    return jax.jit(fn)


def sharded_align(
    mesh: Mesh,
    profile, qidx, ridx, qlen, rlen,
    *,
    open_, ext, mode, free, outputs, width="32", route="auto",
    interpret=False,
):
    """Run the production alignment fill with the batch sharded over
    ``mesh``'s first axis.

    ``route``: "auto" takes the engine's own route decision;
    "kernel"/"wavefront" force one.  ``interpret=True`` (tests only)
    runs the kernel through the Pallas interpreter.  The batch is padded
    internally to a multiple of the device count; outputs are sliced
    back to the true batch.  Returns the same dict as
    :func:`wavefront_align`, with every output sharded over the mesh
    axis.

    ``profile``/``qidx`` with a leading dim of 1 (profile reuse — one
    query against many references) are replicated across the mesh rather
    than sharded.
    """
    ndev = math.prod(mesh.devices.shape)
    axis = mesh.axis_names[0]
    profile = np.asarray(profile)
    qidx = np.asarray(qidx)
    ridx = np.asarray(ridx)
    qlen = np.asarray(qlen, np.int32)
    rlen = np.asarray(rlen, np.int32)
    B, Rp = ridx.shape
    Qp = profile.shape[1]
    shared = profile.shape[0] == 1

    if route == "auto":
        route = plan_sharded_route(outputs=outputs, Qp=Qp, Rp=Rp)
    Bp = (B + ndev - 1) // ndev * ndev

    def padb(x):
        if Bp == x.shape[0]:
            return x
        return np.pad(x, [(0, Bp - x.shape[0])] + [(0, 0)] * (x.ndim - 1))

    batch_sharding = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())

    def put(x, is_shared):
        return jax.device_put(jnp.asarray(x), rep if is_shared else
                              batch_sharding)

    fn = _sharded_fn(mesh, mode, tuple(free), outputs, width, shared,
                     route, interpret)
    out = fn(
        put(profile if shared else padb(profile), shared),
        put(qidx if shared else padb(qidx), shared),
        put(padb(ridx), False), put(padb(qlen), False),
        put(padb(rlen), False),
        jnp.asarray(open_, jnp.int32), jnp.asarray(ext, jnp.int32),
    )
    if Bp != B:
        # slicing a sharded array needs an explicit result sharding; keep
        # the batch axis sharded when the true batch still divides the mesh
        crop = NamedSharding(mesh, P(axis) if B % ndev == 0 else P())
        out = {k: v.at[:B].get(out_sharding=crop) for k, v in out.items()}
    return out


def gather_scores(out: dict) -> dict:
    """Fetch sharded per-pair outputs to host numpy (cross-host: each
    process receives the full batch via the addressable-shards gather
    jax performs on device_get)."""
    return {k: np.asarray(jax.device_get(v)) for k, v in out.items()}
