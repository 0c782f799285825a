"""`repro_torch.fabric` — one query plane over many shard stores (the
port's twin of ``repro.fabric``, speaking its wire format byte for byte).

The source paper scales by replicating duty-cycled cores; this package is
the software analogue at the process level: N shard stores (each a full
``BitmapDB`` + ``BitmapService`` stack) behind ONE submit/future query
surface.  The pieces:

  * :mod:`repro_torch.fabric.envelope` — the typed, pickle-free wire codec
    and the message envelope every fabric hop speaks (trace context rides in
    the envelope, so a query's span chain crosses process boundaries);
  * :mod:`repro_torch.fabric.transport` — the ``Transport`` seam: an
    in-process loopback and a framed-socket transport share one
    request/reply contract (and the ``rpc.send``/``rpc.recv`` fault
    seams, so chaos schedules cover the network);
  * :mod:`repro_torch.fabric.protocol` — ``ServiceHost``: submit / drain /
    metrics / health / append as plain messages over a
    :class:`repro_torch.serve.service.BitmapService`;
  * :mod:`repro_torch.fabric.shardmap` — hash / block partitioning of the
    record space, predicate pruning to owning shards;
  * :mod:`repro_torch.fabric.cluster` — the atomically swapped cluster
    manifest (membership, replica groups, rebalance by segment handoff);
  * :mod:`repro_torch.fabric.client` — :class:`FabricClient`: the
    ``submit()``/future facade that scatters a predicate, hedges reads
    across replicas, and merges per-shard rows bit-identically to a
    single-node session;
  * :mod:`repro_torch.fabric.worker` — the multiprocess shard worker
    entrypoint (spawn a ``BitmapService`` + socket server per store).

Imports stay lazy (the worker spawns fresh interpreters; pulling torch
and the engine at package import would double every child's startup
cost).
"""
from __future__ import annotations

_LAZY = {
    "Envelope": "repro_torch.fabric.envelope",
    "encode": "repro_torch.fabric.envelope",
    "decode": "repro_torch.fabric.envelope",
    "ShardMap": "repro_torch.fabric.shardmap",
    "ClusterManifest": "repro_torch.fabric.cluster",
    "FabricClient": "repro_torch.fabric.client",
    "FabricFuture": "repro_torch.fabric.client",
    "ServiceHost": "repro_torch.fabric.protocol",
    "LoopbackTransport": "repro_torch.fabric.transport",
    "SocketTransport": "repro_torch.fabric.transport",
    "serve_socket": "repro_torch.fabric.transport",
    "spawn_shards": "repro_torch.fabric.worker",
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module 'repro_torch.fabric' has no attribute "
                             f"{name!r}")
    import importlib
    return getattr(importlib.import_module(mod), name)
