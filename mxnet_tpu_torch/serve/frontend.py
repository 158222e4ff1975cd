"""A stdlib asyncio HTTP/JSON front on the fleet's Router (counterpart
of ``mxnet_tpu/serve/frontend.py``).

The wire contract:

- ``POST /v1/infer``: body ``{"inputs": [<nested list>, ...], "tenant":
  str, "deadline_ms": num, "idempotent": bool, "dtype": "float32",
  "stream": bool}``. A plain reply is ``{"outputs": [...], "replica":
  rid, "id": ...}``; with ``"stream": true`` it is ``Transfer-Encoding:
  chunked`` newline-delimited JSON ending in ``{"done": true}`` (the
  ``stream_fn`` seam; the default streams the one final result).
- ``GET /v1/health``: liveness and the count of live replicas.
- ``GET /v1/fleet``: the router's routing table.
- ``GET /metrics``: the telemetry registry in Prometheus text, plus
  every replica's telemetry slice from its lease under ``replica=``
  labels; a failed aggregation falls back to the router's own series.
- ``GET /v1/trace/<id>``: the assembled trace of a request id or trace
  id with its critical path; 404 when unknown.

With ``MXNET_TRACE=1`` an inbound ``x-mxnet-trace`` header
("traceid-spanid-0|1") is honoured, with the caller's sampling
decision, and one is minted otherwise; the context is echoed on the
response.

A typed shed (:class:`~.tenancy.OverloadError`) answers a JSON error
``{"error": {"code", "message", "tenant"}}`` with the status of
``tenancy.http_status`` (429 overload, 504 timeout, 503 drain) and a
``Retry-After`` on the retryable codes.

Router calls block (they drive sockets), so the handler runs them on
the loop's default executor; the loop only parses HTTP and streams.
"""
from __future__ import annotations

import asyncio
import contextlib
import json
import logging
import threading
from typing import Callable, Iterable, Optional

import numpy as np

from .. import telemetry
from .. import tracing
from ..base import MXNetError
from . import fleet as _fleet
from . import tenancy
from .tenancy import OverloadError

__all__ = ["Frontend"]

_LOG = logging.getLogger(__name__)

# Retry-After (seconds) per retryable shed code: overload clears on the
# next batch tick; a draining replica needs the router a heartbeat or
# two to reroute.
_RETRY_AFTER = {"overload": 1, "drain": 1}


def _default_stream(result, meta: dict) -> Iterable[dict]:
    """The default stream: one chunk carrying the final result (a
    decode path replaces it with a per-token generator)."""
    outs = result if isinstance(result, list) else [result]
    yield {"outputs": [np.asarray(o).tolist() for o in outs],
           "replica": meta.get("replica"), "id": meta.get("id")}


class Frontend:
    """HTTP/JSON front of one :class:`~.fleet.Router` (module
    docstring). ``serve_in_thread()`` runs the asyncio loop on a
    daemon thread and returns once the socket is bound (tests,
    tools); embedders with their own loop call ``await start()``."""

    def __init__(self, router, host: str = "127.0.0.1", port: int = 0,
                 stream_fn: Optional[Callable] = None):
        self._router = router
        self._host = host
        self._port = port
        self._stream_fn = stream_fn or _default_stream
        self._server: Optional[asyncio.AbstractServer] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self.addr = (host, port)
        self.address = ""

    # -- lifecycle -----------------------------------------------------
    async def start(self):
        self._loop = asyncio.get_running_loop()
        self._server = await asyncio.start_server(
            self._handle, self._host, self._port)
        self.addr = self._server.sockets[0].getsockname()[:2]
        self.address = "%s:%d" % self.addr
        return self

    def serve_in_thread(self) -> "Frontend":
        started = threading.Event()

        def run():
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)

            async def boot():
                await self.start()
                started.set()

            loop.run_until_complete(boot())
            try:
                loop.run_forever()
            finally:
                loop.close()

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="mx-frontend")
        self._thread.start()
        if not started.wait(timeout=10):
            raise MXNetError("frontend failed to start within 10s")
        return self

    def stop(self):
        loop = self._loop
        if loop is None or not loop.is_running():
            return

        def shutdown():
            if self._server is not None:
                self._server.close()
            for task in asyncio.all_tasks(loop):
                task.cancel()
            loop.stop()

        loop.call_soon_threadsafe(shutdown)
        if self._thread is not None:
            self._thread.join(timeout=5)

    # -- HTTP plumbing -------------------------------------------------
    async def _handle(self, reader, writer):
        try:
            while True:
                req_line = await reader.readline()
                if not req_line:
                    return
                parts = req_line.decode("latin-1").strip().split()
                if len(parts) != 3:
                    await self._respond(writer, 400, {"error": {
                        "code": "error", "message": "malformed request "
                        "line", "tenant": ""}})
                    return
                method, path, _version = parts
                headers = {}
                while True:
                    line = await reader.readline()
                    if line in (b"\r\n", b"\n", b""):
                        break
                    key, _, val = line.decode("latin-1").partition(":")
                    headers[key.strip().lower()] = val.strip()
                length = int(headers.get("content-length") or 0)
                body = await reader.readexactly(length) if length else b""
                keep = headers.get("connection",
                                   "keep-alive").lower() != "close"
                await self._dispatch(writer, method, path, body,
                                     headers)
                await writer.drain()
                if not keep:
                    return
        except (asyncio.IncompleteReadError, ConnectionError,
                BrokenPipeError):
            pass
        except Exception:
            _LOG.warning("frontend: handler error", exc_info=True)
        finally:
            with contextlib.suppress(Exception):
                writer.close()
                await writer.wait_closed()

    async def _respond(self, writer, status: int, payload,
                       content_type: str = "application/json",
                       extra_headers: Iterable[str] = ()):
        if isinstance(payload, (dict, list)):
            body = (json.dumps(payload) + "\n").encode("utf-8")
        else:
            body = payload if isinstance(payload, bytes) \
                else str(payload).encode("utf-8")
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  429: "Too Many Requests", 500: "Internal Server Error",
                  503: "Service Unavailable",
                  504: "Gateway Timeout"}.get(status, "Error")
        head = ["HTTP/1.1 %d %s" % (status, reason),
                "Content-Type: %s" % content_type,
                "Content-Length: %d" % len(body)]
        head.extend(extra_headers)
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin-1")
                     + body)

    async def _error(self, writer, exc: Exception):
        wire = tenancy.to_wire_error(exc)
        status = tenancy.http_status(wire["code"])
        extra = []
        retry = _RETRY_AFTER.get(wire["code"])
        if retry is not None:
            extra.append("Retry-After: %d" % retry)
        await self._respond(writer, status, {"error": wire},
                            extra_headers=extra)

    # -- routes --------------------------------------------------------
    async def _dispatch(self, writer, method: str, path: str,
                        body: bytes, headers: dict):
        path = path.split("?", 1)[0]
        if method == "GET" and path == "/v1/health":
            table = self._router.table()
            live = sum(1 for r in table["replicas"].values()
                       if r["alive"])
            await self._respond(writer, 200, {
                "ok": live > 0, "replicas_live": live,
                "stale": table["stale"]})
        elif method == "GET" and path == "/v1/fleet":
            await self._respond(writer, 200, self._router.table())
        elif method == "GET" and path == "/metrics":
            await self._metrics(writer)
        elif method == "GET" and path.startswith("/v1/trace/"):
            await self._trace(writer, path[len("/v1/trace/"):])
        elif method == "POST" and path == "/v1/infer":
            await self._infer(writer, body, headers)
        else:
            await self._respond(writer, 404, {"error": {
                "code": "error", "message": "no route %s %s"
                % (method, path), "tenant": ""}})

    async def _metrics(self, writer):
        """The fleet's scrape: this process's registry plus every
        replica's telemetry slice from its lease under ``replica=``
        labels. A failed aggregation (a replica publishing garbage)
        never answers 500: the scrape falls back to the router's own
        series, where mx_fleet_routing_stale flags a stale view."""
        text = telemetry.render_prometheus()
        try:
            text += _fleet.render_replica_metrics(self._router)
        except Exception:
            _LOG.warning("frontend: replica metric aggregation failed; "
                         "serving router-local series", exc_info=True)
        await self._respond(writer, 200, text.encode("utf-8"),
                            content_type="text/plain; version=0.0.4")

    async def _trace(self, writer, ident: str):
        """GET /v1/trace/<id> — the assembled cross-process trace for
        a request id or trace id, with its critical-path breakdown.
        404 when unknown (not sampled, evicted, or tracing off)."""
        trace = self._router.trace(ident)
        if trace is None:
            await self._respond(writer, 404, {"error": {
                "code": "error", "message": "unknown trace %r (not "
                "sampled, evicted, or tracing off)" % ident,
                "tenant": ""}})
            return
        trace["critical_path"] = self._router.explain(ident)
        await self._respond(writer, 200, trace)

    async def _infer(self, writer, body: bytes, headers: dict):
        try:
            req = json.loads(body or b"{}")
            inputs = req["inputs"]
            if not isinstance(inputs, list) or not inputs:
                raise ValueError("'inputs' must be a non-empty list "
                                 "of arrays")
            dtype = req.get("dtype", "float32")
            arrays = [np.asarray(a, dtype=dtype) for a in inputs]
        except (ValueError, KeyError, TypeError) as e:
            await self._respond(writer, 400, {"error": {
                "code": "error", "message": "bad /v1/infer body: %s"
                % e, "tenant": ""}})
            return
        tenant = str(req.get("tenant", "default"))
        deadline_ms = req.get("deadline_ms")
        idempotent = bool(req.get("idempotent", True))
        stream = bool(req.get("stream", False))
        # the HTTP edge is where the trace begins: accept the caller's
        # x-mxnet-trace context (their sampling decision is respected)
        # or mint one here — the sampling coin is flipped exactly once
        tctx = None
        if tracing.active():
            tctx = tracing.from_header(headers.get("x-mxnet-trace"))
            if tctx is None:
                tctx = tracing.mint()
        trace_hdr = ("x-mxnet-trace: %s" % tctx.to_header()
                     if tctx is not None else None)
        loop = asyncio.get_running_loop()

        def work():
            fut = self._router.submit(
                *arrays, tenant=tenant, deadline_ms=deadline_ms,
                idempotent=idempotent, trace=tctx)
            return fut.result(), fut

        try:
            result, fut = await loop.run_in_executor(None, work)
        except Exception as e:
            await self._error(writer, e)
            return
        meta = {"replica": fut.replica, "id": fut.id}
        if not stream:
            outs = result if isinstance(result, list) else [result]
            payload = {
                "outputs": [np.asarray(o).tolist() for o in outs],
                "replica": fut.replica, "id": fut.id}
            if tctx is not None and tctx.sampled:
                payload["trace_id"] = tctx.trace_id
            await self._respond(
                writer, 200, payload,
                extra_headers=[trace_hdr] if trace_hdr else ())
            return
        # chunked streaming: newline-delimited JSON, one HTTP chunk per
        # stream_fn chunk, closed by {"done": true}
        head = ("HTTP/1.1 200 OK\r\n"
                "Content-Type: application/x-ndjson\r\n"
                "Transfer-Encoding: chunked\r\n")
        if trace_hdr:
            head += trace_hdr + "\r\n"
        writer.write((head + "\r\n").encode("latin-1"))
        try:
            for chunk in self._stream_fn(result, meta):
                self._write_chunk(writer, chunk)
                await writer.drain()
        except Exception as e:
            self._write_chunk(writer, {"error": tenancy.to_wire_error(e)})
        self._write_chunk(writer, {"done": True})
        writer.write(b"0\r\n\r\n")

    @staticmethod
    def _write_chunk(writer, payload: dict):
        data = (json.dumps(payload) + "\n").encode("utf-8")
        writer.write(b"%x\r\n" % len(data) + data + b"\r\n")
