"""``ServiceHost`` — a :class:`repro_torch.serve.service.BitmapService` as a
message handler (the port's twin of ``repro.fabric.protocol``).

One host maps the fabric's envelope kinds onto the service API; it is
transport-agnostic — the loopback transport calls :meth:`handle`
directly, the socket server calls it per decoded frame.  ``handle`` is
asynchronous by contract: it returns as soon as the request is enqueued
and delivers the reply through the callback when ready, so a query
envelope rides the service's micro-batch scheduler exactly like a local
``submit()`` (the resolver thread waits on the futures; the scheduler
coalesces as usual).

The service answers with int32 tensors on the session's device.  The
resolver stacks one envelope's live rows (and counts) on that device and
copies each stack to the host once, then reinterprets the int32 words as
the wire's uint32 (``.view``, no value conversion): one synchronize per
envelope, not one per query.  Appended records go to the session as
received; its ``append_encoded`` moves them to the device and casts them
there.

Envelope kinds (the protocol ARCHITECTURE.md documents)::

    ping      {}                            -> pong {shard_id}
    info      {}                            -> info {shard_id,
                                               num_records, num_keys}
    query     {queries: [wire trees],       -> result {rows (Q, Nw) u32
               count_only: bool}               | None, counts (Q,) i64,
                                               num_records, errors:
                                               [[qi, message], ...]}
    append    {stream, seq,                 -> appended {seq, num_records,
               records: (N, W) i32}            duplicate: bool}
    drain     {timeout_s?}                  -> drained {ok}
    metrics   {}                            -> metrics {...}  (the
                                               ServiceMetrics dict, incl.
                                               the energy-ledger snapshot,
                                               plus ``process``)
    health    {}                            -> health {...,  process}
    shutdown  {}                            -> bye {}  (then the worker's
                                               on_shutdown runs)

Anything that raises maps to an ``error`` reply carrying the exception
type and message — never a dropped request.

**Exactly-once appends**: every append carries a per-stream sequence
number; the host remembers the highest applied seq per stream and
acknowledges (without re-applying) anything at or below it.  A client
that never got the ack retries the SAME seq, so drops and duplicates on
either leg converge to applied-exactly-once + acked.

``process`` (the port's addition; a reference client ignores it) holds
this process's bitmap waves per resolved backend
(:func:`repro_torch.engine.batch.waves_by_backend`) and every kernel
wrapper's launch counter: over the wire, it is how a caller sees that a
worker's waves ran on the kernels (``cuda``) and not on a plain backend.
The counters are per process, so hosts sharing one process report the
same numbers.

**Trace propagation**: a request envelope's ``trace`` tuple becomes the
parent of the host-side ``rpc.<kind>`` span — the one rule that stitches
client and shard span trees into a single cross-process trace.
"""
from __future__ import annotations

import os
import queue
import threading

import numpy as np
import torch

from repro_torch.fabric.envelope import Envelope
from repro_torch.obs import trace as obs_trace

__all__ = ["ServiceHost"]


class ServiceHost:
    """See module docstring.  ``shard_id`` names this shard in replies
    and health artifacts; ``on_shutdown`` (worker processes pass one)
    runs after a ``shutdown`` envelope is acknowledged."""

    def __init__(self, service: "BitmapService", *, shard_id: int = 0,
                 on_shutdown=None):
        self.service = service
        self.shard_id = shard_id
        self._shutdown_cb = on_shutdown
        self._applied_seq: dict[str, int] = {}    # stream -> highest seq
        self._append_lock = threading.Lock()
        self._resolveq: queue.SimpleQueue = queue.SimpleQueue()
        self._closed = False
        self._resolver = threading.Thread(
            target=self._resolve_loop,
            name=f"fabric-host-{shard_id}", daemon=True)
        self._resolver.start()

    # -------------------------------------------------------------- dispatch
    def handle(self, env: Envelope, reply) -> None:
        """Process one request; ``reply(Envelope)`` is called exactly
        once, possibly from another thread, possibly after this
        returns."""
        tr = obs_trace.TRACER
        if tr is None:
            self._dispatch(env, reply)
            return
        with tr.span(f"rpc.{env.kind}", parent=env.trace,
                     shard=self.shard_id, msg_id=env.msg_id):
            self._dispatch(env, reply)

    def _dispatch(self, env: Envelope, reply) -> None:
        try:
            fn = getattr(self, f"_on_{env.kind}", None)
            if fn is None:
                reply(env.reply("error", type="ValueError",
                                error=f"unknown envelope kind "
                                      f"{env.kind!r}"))
                return
            fn(env, reply)
        except BaseException as e:       # noqa: BLE001 — to the wire
            reply(env.reply("error", type=type(e).__name__,
                            error=str(e)))

    # -------------------------------------------------------------- handlers
    def _on_ping(self, env: Envelope, reply) -> None:
        reply(env.reply("pong", shard_id=self.shard_id))

    def _on_info(self, env: Envelope, reply) -> None:
        db = self.service.db
        reply(env.reply("info", shard_id=self.shard_id,
                        num_records=int(db.num_records),
                        num_keys=int(db.num_keys)))

    def _on_query(self, env: Envelope, reply) -> None:
        from repro_torch.fabric.envelope import query_from_wire
        queries = [query_from_wire(w) for w in env.payload["queries"]]
        count_only = bool(env.payload.get("count_only", False))
        # trace context is captured HERE (inside the rpc.query span) so
        # the admission/queue/serve spans the service records parent
        # under the cross-process request
        futs = [self.service.submit(q) for q in queries]
        self._resolveq.put((env, futs, count_only, reply))

    def _resolve_loop(self) -> None:
        """Waits out query futures OFF the transport thread: the socket
        reader keeps draining frames (more queries coalesce into the
        running wave) while earlier envelopes await their results."""
        while True:
            item = self._resolveq.get()
            if item is None:
                return
            env, futs, count_only, reply = item
            try:
                out = env.reply("result",
                                **_result_payload(futs, count_only))
            except Exception as e:           # a device copy failed
                out = env.reply("error", type=type(e).__name__,
                                error=str(e))
            try:
                reply(out)
            except BaseException:            # noqa: BLE001 — peer gone
                pass

    def _on_append(self, env: Envelope, reply) -> None:
        p = env.payload
        stream = p["stream"]
        seq = int(p["seq"])
        records = p["records"]
        with self._append_lock:
            last = self._applied_seq.get(stream, 0)
            if seq <= last:
                reply(env.reply(
                    "appended", seq=seq, duplicate=True,
                    num_records=int(self.service.db.num_records)))
                return
            if seq != last + 1:
                reply(env.reply(
                    "error", type="GapError",
                    error=f"stream {stream!r}: seq {seq} after {last} "
                          f"(a gap means an earlier append was lost "
                          f"client-side — refuse, don't reorder)"))
                return
            n = self.service.db.append_encoded(records)
            self._applied_seq[stream] = seq
        reply(env.reply("appended", seq=seq, duplicate=False,
                        num_records=int(n)))

    def _on_drain(self, env: Envelope, reply) -> None:
        ok = self.service.drain(timeout=env.payload.get("timeout_s"))
        reply(env.reply("drained", ok=bool(ok)))

    def _on_metrics(self, env: Envelope, reply) -> None:
        reply(env.reply("metrics", shard_id=self.shard_id,
                        **_plain(self.service.metrics().to_dict()),
                        process=process_counters()))

    def _on_health(self, env: Envelope, reply) -> None:
        reply(env.reply("health", shard_id=self.shard_id,
                        **_plain(self.service.health()),
                        process=process_counters()))

    def _on_shutdown(self, env: Envelope, reply) -> None:
        reply(env.reply("bye", shard_id=self.shard_id))
        if self._shutdown_cb is not None:
            self._shutdown_cb()

    # ------------------------------------------------------------- lifecycle
    def close(self, timeout: float | None = None) -> None:
        """Stop the resolver (after it drains queued work) and close the
        underlying service.  Idempotent."""
        if not self._closed:
            self._closed = True
            self._resolveq.put(None)
            self._resolver.join(timeout=timeout)
        self.service.close(timeout=timeout)


def _result_payload(futs, count_only: bool) -> dict:
    """One query envelope's ``result`` payload from its service futures:
    counts (Q,) int64; unless ``count_only``, rows (Q, Nw) uint32 with
    failed slots as zero rows (every live row shares the wave-padded word
    width; a narrower one, from an earlier wave, is zero-extended).  The
    live rows and counts are stacked on their device and copied to the
    host once each."""
    live, rows_t, counts_t, errors = [], [], [], []
    n = 0
    for qi, fut in enumerate(futs):
        try:
            row, count = fut.result()
        except BaseException as e:           # noqa: BLE001 — per query
            errors.append([qi, f"{type(e).__name__}: {e}"])
            continue
        live.append(qi)
        rows_t.append(row)
        counts_t.append(count)
        n = max(n, fut._n)
    counts = np.zeros(len(futs), np.int64)
    if live:
        counts[live] = torch.stack(counts_t).cpu().numpy()
    rows = None
    if not count_only:
        width = max((r.shape[-1] for r in rows_t), default=0)
        rows = np.zeros((len(futs), width), np.uint32)
        if live:
            stacked = torch.stack([
                torch.nn.functional.pad(r, (0, width - r.shape[-1]))
                if r.shape[-1] != width else r for r in rows_t])
            rows[live] = stacked.cpu().numpy().view(np.uint32)
    return {"rows": rows, "counts": counts, "num_records": int(n),
            "errors": errors}


def process_counters() -> dict:
    """This process's bitmap waves per resolved backend and every kernel
    wrapper's launch count (see the module docstring)."""
    from repro_torch.engine import batch
    from repro_torch.kernels import (attention, bit_transpose, bitmap_ops,
                                     cam_match)
    wrappers = (cam_match.cam_match, bit_transpose.bit_transpose,
                bitmap_ops.bitmap_query, bitmap_ops.bulk_program,
                bitmap_ops.bulk_program_stacked,
                attention.flash_attention_fwd)
    return {"pid": os.getpid(),
            "waves_by_backend": batch.waves_by_backend(),
            "launches": {fn.__name__: fn.launches for fn in wrappers}}


def _plain(obj):
    """Wire-encodable copy of a metrics/health tree: numpy scalars to
    Python, tuples preserved, Nones kept (the codec handles the rest)."""
    if isinstance(obj, dict):
        return {str(k): _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, float) and obj != obj:      # NaN -> None (wire)
        return None
    return obj
