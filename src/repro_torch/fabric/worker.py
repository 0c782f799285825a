"""Multiprocess shard workers: one ``BitmapDB`` + ``BitmapService`` +
socket server per spawned process (the port's twin of
``repro.fabric.worker``).

:func:`spawn_shards` launches N workers (``multiprocessing`` spawn
context — each child is a fresh interpreter that imports torch on its
own; a fork after the parent has touched CUDA would be broken) and
returns a :class:`ShardFleet` with their bound addresses; the parent then
builds a :class:`~repro_torch.fabric.client.FabricClient` over them with
``FabricClient.connect``.  Each worker:

  * opens its store on ``device`` (``store_path`` with a committed
    manifest resumes it; a bare path creates a durable store; neither ->
    in-memory) and optionally ingests a records array handed to it at
    spawn, in the caller's integer dtype (the session casts on the
    device);
  * optionally installs a JSONL-sink :class:`~repro_torch.obs.trace.Tracer`
    and, on shutdown, writes ``shard-<id>-health.json`` /
    ``shard-<id>-metrics.json`` — the per-shard artifacts;
  * serves until a ``shutdown`` envelope arrives (the fleet's
    ``close()`` sends one per worker, then joins with a terminate
    fallback so a wedged worker cannot hang the parent).

A worker that cannot start (no card behind ``device="cuda"``, a corrupt
store) reports its error to the parent, and :func:`spawn_shards` raises:
there is no silent CPU child.  On a CUDA device the parent builds the
kernel libraries before spawning, so the children load them instead of
racing ``nvcc``.
"""
from __future__ import annotations

import json
import multiprocessing as mp
import os
import threading

import numpy as np

__all__ = ["ShardFleet", "spawn_shards"]


def _shard_main(conn, shard_id: int, store_path: str | None,
                schema_text: str | None, num_keys: int | None,
                records: np.ndarray | None, config_kw: dict,
                artifact_dir: str | None, device: str) -> None:
    """Worker entrypoint (spawn target — top-level and import-light
    until inside, so child startup stays cheap)."""
    from repro_torch.fabric.protocol import ServiceHost
    from repro_torch.fabric.transport import serve_socket
    from repro_torch.obs import trace as obs_trace
    from repro_torch.store import format as fmt

    tracer = None
    sink_f = None
    try:
        if artifact_dir:
            os.makedirs(artifact_dir, exist_ok=True)
            sink_f = open(os.path.join(artifact_dir,
                                       f"shard-{shard_id}-trace.jsonl"),
                          "w", buffering=1)

            def sink(d, _f=sink_f):
                _f.write(json.dumps(d) + "\n")

            tracer = obs_trace.install(obs_trace.Tracer(sink=sink))
        service = _open_service(store_path, schema_text, num_keys, records,
                                config_kw, device)
    except Exception as e:
        conn.send(("error", f"{type(e).__name__}: {e}"))
        conn.close()
        raise
    done = threading.Event()
    host = ServiceHost(service, shard_id=shard_id,
                       on_shutdown=done.set)
    server = serve_socket(host)
    conn.send(("ready", server.address))
    conn.close()
    try:
        done.wait()
    finally:
        if artifact_dir:
            try:
                # atomic + seamed (format.write): a fault plan can tear
                # or drop these exactly like any other durable artifact
                fmt.write_json_atomic(
                    os.path.join(artifact_dir,
                                 f"shard-{shard_id}-metrics.json"),
                    _jsonable(service.metrics().to_dict()))
                fmt.write_json_atomic(
                    os.path.join(artifact_dir,
                                 f"shard-{shard_id}-health.json"),
                    _jsonable(service.health()))
            except Exception:           # noqa: BLE001 — artifacts only
                pass
        server.close()
        host.close()
        if tracer is not None:
            obs_trace.uninstall(tracer)
        if sink_f is not None:
            sink_f.close()


def _open_service(store_path, schema_text, num_keys, records, config_kw,
                  device):
    """The worker's session on ``device`` (see the module docstring),
    with ``records`` ingested, behind a ``BitmapService``."""
    from repro_torch import db as db_mod
    from repro_torch.db.schema import Schema
    from repro_torch.serve.service import BitmapService, ServiceConfig

    schema = Schema.from_json(schema_text) if schema_text else None
    if store_path and os.path.exists(os.path.join(store_path, "CURRENT")):
        session = db_mod.BitmapDB.open(store_path, num_keys=num_keys,
                                       device=device)
    elif store_path:
        session = db_mod.BitmapDB(schema, num_keys=num_keys,
                                  path=store_path, device=device)
    else:
        session = db_mod.BitmapDB(schema, num_keys=num_keys, device=device)
    if records is not None and records.shape[0]:
        session.append_encoded(records)
    return BitmapService(session, ServiceConfig(**config_kw))


def _jsonable(obj):
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, float) and obj != obj:
        return None
    return obj


class ShardFleet:
    """Handle to a set of spawned shard workers."""

    def __init__(self, procs, addresses):
        self.procs = procs
        self.addresses: list[tuple[str, int]] = addresses
        self._closed = False

    def __enter__(self) -> "ShardFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self, timeout: float = 30.0) -> None:
        """Ask every worker to shut down (a ``shutdown`` envelope over a
        short-lived connection), then join; terminate stragglers."""
        if self._closed:
            return
        self._closed = True
        from repro_torch.fabric.envelope import Envelope
        from repro_torch.fabric.transport import SocketTransport
        for addr in self.addresses:
            try:
                t = SocketTransport(addr, connect_timeout=2.0)
                try:
                    t.request(Envelope("shutdown"), timeout=5.0)
                finally:
                    t.close()
            except OSError:
                pass                    # already gone
        for p in self.procs:
            p.join(timeout=timeout / max(len(self.procs), 1))
        for p in self.procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)


def spawn_shards(num_shards: int, *, schema=None, num_keys=None,
                 store_paths=None, shard_records=None,
                 service_config: dict | None = None,
                 artifact_dir: str | None = None, device="cuda",
                 start_timeout_s: float = 120.0) -> ShardFleet:
    """Launch ``num_shards`` worker processes, each with its session on
    ``device`` (default the card), and wait for their bound addresses.
    ``shard_records`` (optional) is one encoded ``(N, W)`` integer array
    per shard, handed over in its own dtype and ingested before the
    worker reports ready — the parent typically produced it with
    ``ShardMap.partition`` and keeps the matching gid tables for its
    client.  Raises if any worker fails to start."""
    device = str(device)
    if device.startswith("cuda"):
        from repro_torch.kernels import _build
        _build.build_all()
    ctx = mp.get_context("spawn")
    schema_text = schema.to_json() if schema is not None else None
    procs, conns = [], []
    for sid in range(num_shards):
        parent, child = ctx.Pipe()
        recs = None if shard_records is None else \
            np.asarray(shard_records[sid])
        sp = None if store_paths is None else store_paths[sid]
        p = ctx.Process(
            target=_shard_main,
            args=(child, sid, sp, schema_text, num_keys, recs,
                  dict(service_config or {}), artifact_dir, device),
            name=f"repro-torch-shard-{sid}", daemon=True)
        p.start()
        child.close()
        procs.append(p)
        conns.append(parent)
    addresses = []
    try:
        for sid, conn in enumerate(conns):
            if not conn.poll(start_timeout_s):
                raise TimeoutError(f"shard {sid} did not come up within "
                                   f"{start_timeout_s}s")
            try:
                tag, addr = conn.recv()
            except EOFError:
                raise RuntimeError(f"shard {sid} exited before it came "
                                   "up") from None
            if tag != "ready":
                raise RuntimeError(f"shard {sid} failed to start: "
                                   f"{addr}")
            addresses.append(tuple(addr))
            conn.close()
    except BaseException:
        for p in procs:
            p.terminate()
        for p in procs:
            p.join(timeout=5.0)
        raise
    return ShardFleet(procs, addresses)
