"""Multi-host process-group setup and cross-host result gathering.

The reference has no distributed layer at all (SURVEY.md §2.3/§5.8);
here: one Python process per host, connected with
``jax.distributed.initialize``, a global mesh spanning every device,
pair batches sharded over the global ``data`` axis (each host feeds its
addressable shard), and scores/ends gathered with ``multihost_utils``.
Only the batch scatter / result gather cross the host boundary.
"""

from __future__ import annotations

import numpy as np


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join (or bootstrap) the multi-host process group.

    Where the cluster environment describes the process group every
    argument is auto-detected; otherwise (a single GPU host, or CPU
    simulation) pass all three explicitly (see tests/test_multihost.py).
    """
    import jax

    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)


def global_mesh(axis: str = "data"):
    """A 1-D mesh over every device (all hosts)."""
    import jax

    return jax.make_mesh((len(jax.devices()),), (axis,))


def host_local_to_global(mesh, arrays: dict):
    """Assemble per-host shards into global batch-sharded arrays.

    Each process passes ITS slice of the batch (same order across
    processes); the result is a global jax.Array sharded over ``data``.
    """
    from jax.experimental import multihost_utils
    from jax.sharding import PartitionSpec as P

    return {
        k: multihost_utils.host_local_array_to_global_array(v, mesh, P("data"))
        for k, v in arrays.items()
    }


def global_to_host_local(mesh, out: dict):
    """Fetch the full (concatenated) per-pair outputs on every host
    (cross-host allgather over DCN)."""
    from jax.experimental import multihost_utils

    return {
        k: np.asarray(multihost_utils.process_allgather(v, tiled=True))
        for k, v in out.items()
    }


def align_global(mesh, profile, qidx, ridx, qlen, rlen, *,
                 open_, ext, mode, free, outputs, width="32", route="auto",
                 interpret=False):
    """Multi-host batched alignment: host-local shards in, full results
    out on every host.

    Routes through the same decision as the single-host engine
    (dist.sharded.plan_sharded_route).  Each host's local batch is padded
    to a multiple of its device count; padding rows are dropped from the
    gathered results.  ``interpret=True`` is for tests only.
    """
    import jax
    from jax.experimental import multihost_utils
    from jax.sharding import PartitionSpec as P

    from .sharded import _sharded_fn, plan_sharded_route

    profile = np.asarray(profile)
    qidx = np.asarray(qidx)
    ridx = np.asarray(ridx)
    qlen = np.asarray(qlen, np.int32)
    rlen = np.asarray(rlen, np.int32)
    B_local, Rp = ridx.shape
    Qp = profile.shape[1]
    shared = profile.shape[0] == 1
    dloc = jax.local_device_count()
    nproc = jax.process_count()

    if route == "auto":
        route = plan_sharded_route(outputs=outputs, Qp=Qp, Rp=Rp)
    Bp_local = (B_local + dloc - 1) // dloc * dloc

    def padb(x):
        if Bp_local == x.shape[0]:
            return x
        return np.pad(x, [(0, Bp_local - x.shape[0])]
                      + [(0, 0)] * (x.ndim - 1))

    def to_global(v, spec):
        return multihost_utils.host_local_array_to_global_array(v, mesh, spec)

    axis = mesh.axis_names[0]
    qspec = P() if shared else P(axis)
    g_profile = to_global(profile if shared else padb(profile), qspec)
    g_qidx = to_global(qidx if shared else padb(qidx), qspec)
    g_ridx = to_global(padb(ridx), P(axis))
    g_qlen = to_global(padb(qlen), P(axis))
    g_rlen = to_global(padb(rlen), P(axis))

    fn = _sharded_fn(mesh, mode, tuple(free), outputs, width, shared,
                     route, interpret)
    out = fn(g_profile, g_qidx, g_ridx, g_qlen, g_rlen,
             np.int32(open_), np.int32(ext))
    host = global_to_host_local(mesh, out)
    if Bp_local != B_local:
        keep = np.concatenate(
            [p * Bp_local + np.arange(B_local) for p in range(nproc)])
        host = {k: v[keep] for k, v in host.items()}
    return host
