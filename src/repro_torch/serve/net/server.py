"""The asyncio HTTP front end over :class:`~repro_torch.serve.InferenceService`.

The counterpart of :mod:`repro.serve.net.server`, with its routes and its
status mapping.  The asyncio loop only parses, admits and answers: the rows
go to the endpoint's micro-batching scheduler, whose worker thread runs the
artifact on its device (the card's kernels for a ``cuda`` artifact).

Request path (the service boundary the paper's latency/throughput trade-off
is measured at):

1. admission — per-endpoint token bucket + queue-depth watermark
   (:mod:`.admission`); refusals answer 429/503 with ``Retry-After``
   *before* touching the scheduler, so the queue stays bounded;
2. submit — rows go to the endpoint's micro-batching scheduler; the
   asyncio loop awaits the scheduler future without blocking other
   connections;
3. respond — predictions plus the degraded-precision flag of the batch
   that served them; full request latency is recorded in the SLO tracker
   (:mod:`.slo`) and surfaced in ``/v1/stats``.

Routes::

    GET  /v1/health               liveness + endpoint count
    GET  /v1/endpoints            hosted artifacts (format/backend/buckets)
    GET  /v1/stats                scheduler + SLO + admission counters
    POST /v1/predict/<endpoint>   {"rows": [[...], ...]} -> predictions

Stdlib only (asyncio streams + the minimal framing in :mod:`.protocol`);
one process, one loop — scale-out is replicas behind an external balancer,
matching the repo's data-parallel serving story.
"""

from __future__ import annotations

import asyncio
import time
from typing import Dict, Optional, Tuple, Union

import numpy as np

from .. import faults
from ..reliability import ServeError
from ..router import Endpoint
from ..service import InferenceService
from .admission import AdmissionController, AdmissionPolicy
from .protocol import (ProtocolError, Request, read_request, response_bytes)
from .slo import SLOTracker

__all__ = ["HttpServer"]

_PREDICT_PREFIX = "/v1/predict/"


class HttpServer:
    """One InferenceService behind ``host:port``.

    ``admission`` is an :class:`AdmissionPolicy` applied to every endpoint
    (each gets its own controller — token buckets are per-endpoint state),
    or a dict ``{endpoint name: AdmissionPolicy}`` for per-endpoint knobs;
    ``None`` admits everything.  ``slo`` is the shared
    :class:`SLOTracker`; pass one configured with per-endpoint p99 targets
    to get violation accounting in ``/v1/stats``.
    """

    def __init__(self, service: InferenceService, host: str = "127.0.0.1",
                 port: int = 0,
                 admission: Union[AdmissionPolicy,
                                  Dict[str, AdmissionPolicy], None] = None,
                 slo: Optional[SLOTracker] = None):
        self.service = service
        self.host = host
        self.port = port  # 0 = ephemeral; real port known after start()
        self.slo = slo or SLOTracker()
        self._admission_cfg = admission
        self._controllers: Dict[str, AdmissionController] = {}
        self._server: Optional[asyncio.base_events.Server] = None
        self._closing = False
        self._busy = 0  # requests currently being handled (drain signal)
        self._writers: set = set()  # open connections (closed on stop)

    # -- lifecycle -----------------------------------------------------------
    async def start(self) -> "HttpServer":
        self._server = await asyncio.start_server(
            self._handle_connection, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    @property
    def address(self) -> str:
        return f"http://{self.host}:{self.port}"

    async def stop(self, drain_timeout: float = 5.0) -> None:
        """Stop accepting, let in-flight requests finish (up to
        ``drain_timeout`` seconds), then drop idle connections."""
        self._closing = True
        if self._server is not None:
            self._server.close()
        deadline = time.perf_counter() + drain_timeout
        while self._busy and time.perf_counter() < deadline:
            await asyncio.sleep(0.01)
        # Kick idle keep-alive connections: closing the transport wakes
        # their blocked reads with EOF and the handlers exit.
        for w in list(self._writers):
            w.close()
        await asyncio.sleep(0)  # let handlers observe the close

    async def serve(self, duration: Optional[float] = None) -> None:
        """start() + run until ``duration`` elapses (forever when None),
        then drain and stop — the launcher's one-call entry point."""
        await self.start()
        try:
            if duration is None:
                await asyncio.Event().wait()  # until cancelled
            else:
                await asyncio.sleep(duration)
        finally:
            await self.stop()

    # -- plumbing ------------------------------------------------------------
    def _controller(self, name: str) -> Optional[AdmissionController]:
        cfg = self._admission_cfg
        if cfg is None:
            return None
        ctrl = self._controllers.get(name)
        if ctrl is None:
            policy = cfg.get(name) if isinstance(cfg, dict) else cfg
            if policy is None:
                return None
            ctrl = self._controllers[name] = AdmissionController(policy)
        return ctrl

    async def _handle_connection(self, reader: asyncio.StreamReader,
                                 writer: asyncio.StreamWriter) -> None:
        self._writers.add(writer)
        try:
            while not self._closing:
                try:
                    req = await read_request(reader)
                except ProtocolError as e:
                    writer.write(response_bytes(
                        e.status, {"error": e.detail}, keep_alive=False))
                    await writer.drain()
                    return
                if req is None:
                    return
                self._busy += 1
                try:
                    status, payload = await self._route(req)
                except ProtocolError as e:
                    status, payload = e.status, response_bytes(
                        e.status, {"error": e.detail},
                        keep_alive=req.keep_alive)
                except Exception as e:  # noqa: BLE001 — surface, don't die
                    status, payload = 500, response_bytes(
                        500, {"error": f"{type(e).__name__}: {e}"},
                        keep_alive=req.keep_alive)
                finally:
                    self._busy -= 1
                writer.write(payload)
                await writer.drain()
                if not req.keep_alive:
                    return
        except (ConnectionError, asyncio.CancelledError):
            pass
        finally:
            self._writers.discard(writer)
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    # -- routing -------------------------------------------------------------
    async def _route(self, req: Request) -> Tuple[int, bytes]:
        # Chaos hook: lets a fault plan fail/delay whole requests at the
        # boundary (an InjectedFault here answers as a typed 500).
        faults.fire("http.request", name=req.path)
        if req.path.startswith(_PREDICT_PREFIX):
            if req.method != "POST":
                raise ProtocolError(405, "predict requires POST")
            return await self._predict(req, req.path[len(_PREDICT_PREFIX):])
        if req.method != "GET":
            raise ProtocolError(405, f"{req.path} requires GET")
        if req.path == "/v1/health":
            return 200, response_bytes(200, {
                "status": "draining" if self._closing else "ok",
                "endpoints": len(self.service.router.names()),
            }, keep_alive=req.keep_alive)
        if req.path == "/v1/endpoints":
            return 200, response_bytes(
                200, {name: self._describe(self.service.router[name])
                      for name in self.service.router.names()},
                keep_alive=req.keep_alive)
        if req.path == "/v1/stats":
            return 200, response_bytes(200, {
                "endpoints": self.service.stats(),
                "slo": self.slo.snapshot(),
                "admission": {name: c.stats()
                              for name, c in self._controllers.items()},
            }, keep_alive=req.keep_alive)
        raise ProtocolError(404, f"no route {req.method} {req.path}")

    @staticmethod
    def _describe(ep: Endpoint) -> Dict:
        art = ep.artifact
        desc = {
            "kind": art.kind,
            "number_format": art.target.number_format,
            "backend": art.target.backend,
            "replicas": art.replicas,
            "max_batch": ep.policy.max_batch,
            "buckets": list(ep.policy.buckets()),
            "degradation": None,
        }
        if ep.fallback is not None:
            desc["degradation"] = {
                "fallback_format": ep.fallback.target.number_format,
                **ep.governor.snapshot(),
            }
        return desc

    async def _predict(self, req: Request, name: str) -> Tuple[int, bytes]:
        t0 = time.perf_counter()
        if name not in self.service.router:
            raise ProtocolError(404, f"no endpoint '{name}'")
        ep = self.service.router[name]
        if "generate" in ep.artifact.extras:
            raise ProtocolError(405, f"endpoint '{name}' hosts an LM "
                                     f"artifact; predict serves classifiers")
        ctrl = self._controller(name)
        if ctrl is not None:
            verdict = ctrl.admit(ep.batcher.depth())
            if not verdict.ok:
                # Refusals count toward the endpoint's SLO record: an
                # admission-bounded system answers fast, and that IS its
                # overload behavior at the boundary.
                self.slo.record(name, time.perf_counter() - t0)
                return verdict.status, response_bytes(
                    verdict.status,
                    {"error": verdict.reason, "endpoint": name},
                    headers={"Retry-After":
                             f"{verdict.retry_after_s:.3f}"},
                    keep_alive=req.keep_alive)
        body = req.json()
        rows = self._parse_rows(req, body)
        timeout_s = self._deadline_s(req, body, t0)
        try:
            futs = [ep.submit(chunk, timeout_s=timeout_s)
                    for chunk in self._chunks(rows, ep.policy.max_batch)]
            parts = [await asyncio.wrap_future(f) for f in futs]
        except ServeError as e:
            # Structured serving failure (deadline, open circuit, isolated
            # dispatch error): a typed JSON response with a stable machine
            # code, Retry-After when the error knows its horizon.
            latency = time.perf_counter() - t0
            self.slo.record(name, latency)
            headers = None
            if e.retry_after_s is not None:
                headers = {"Retry-After": f"{e.retry_after_s:.3f}"}
            return e.status, response_bytes(
                e.status, {"error": str(e), "code": e.code,
                           "endpoint": name},
                headers=headers, keep_alive=req.keep_alive)
        except RuntimeError as e:  # scheduler closed mid-drain
            raise ProtocolError(503, str(e))
        preds = np.concatenate(parts, axis=0)
        meta = getattr(futs[-1], "batch_meta", None) or {}
        latency = time.perf_counter() - t0
        if ctrl is not None:
            ctrl.record_drain(1, latency)
        self.slo.record(name, latency)
        return 200, response_bytes(200, {
            "endpoint": name,
            "predictions": preds.tolist(),
            "degraded": bool(meta.get("degraded", False)),
            "number_format": meta.get("number_format",
                                      ep.artifact.target.number_format),
            "latency_ms": latency * 1e3,
        }, keep_alive=req.keep_alive)

    @staticmethod
    def _deadline_s(req: Request, body, t0: float) -> Optional[float]:
        """Per-request deadline: ``deadline_ms`` in the JSON body, or an
        ``x-deadline-ms`` header (body wins).  Returns the remaining budget
        in seconds relative to ``t0`` (request arrival), or None."""
        raw = None
        if isinstance(body, dict) and body.get("deadline_ms") is not None:
            raw = body["deadline_ms"]
        elif req.headers.get("x-deadline-ms"):
            raw = req.headers["x-deadline-ms"]
        if raw is None:
            return None
        try:
            deadline_ms = float(raw)
        except (TypeError, ValueError):
            raise ProtocolError(400, f"deadline_ms is not a number: {raw!r}")
        if deadline_ms <= 0:
            raise ProtocolError(400, "deadline_ms must be > 0")
        return max(0.0, deadline_ms / 1e3 - (time.perf_counter() - t0))

    @staticmethod
    def _parse_rows(req: Request, body=None) -> np.ndarray:
        if body is None:
            body = req.json()
        if not isinstance(body, dict) or "rows" not in body:
            raise ProtocolError(400, 'body must be {"rows": [[...], ...]}')
        try:
            rows = np.asarray(body["rows"], np.float32)
        except (ValueError, TypeError) as e:
            raise ProtocolError(400, f"rows are not a numeric matrix: {e}")
        if rows.ndim == 1:
            rows = rows[None, :]
        if rows.ndim != 2 or 0 in rows.shape:
            raise ProtocolError(400, f"rows must be a non-empty matrix, "
                                     f"got shape {rows.shape}")
        return rows

    @staticmethod
    def _chunks(rows: np.ndarray, max_batch: int):
        for i in range(0, rows.shape[0], max_batch):
            yield rows[i:i + max_batch]
