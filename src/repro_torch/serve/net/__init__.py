"""repro_torch.serve.net — the network serving plane over InferenceService.

The counterpart of :mod:`repro.serve.net`, standard library and numpy only.

Layers (bottom-up):

* :mod:`repro_torch.serve.net.protocol` — minimal HTTP/1.1 framing over asyncio
  streams (stdlib only; Content-Length bodies, keep-alive, typed
  :class:`ProtocolError` for everything malformed).
* :mod:`repro_torch.serve.net.admission` — :class:`AdmissionController`:
  token-bucket rate limiting + queue-depth watermarks answering 429/503
  with ``Retry-After`` instead of growing the scheduler queue unboundedly.
* :mod:`repro_torch.serve.net.slo` — :class:`SLOTracker`: time-bounded rolling
  latency histograms (p50/p95/p99 over the last window, not the last N
  requests) with per-endpoint SLO-violation counters.
* :mod:`repro_torch.serve.net.server` — :class:`HttpServer`: the asyncio front
  end routing ``/v1/predict/<endpoint>``, ``/v1/health``,
  ``/v1/endpoints``, and ``/v1/stats`` into the micro-batching scheduler.

The load-adaptive *precision* half of overload behavior lives one level
down in :mod:`repro_torch.serve.degrade` (transport-independent: the router's
dispatch path consults it whether requests arrive by socket or by call).
"""

from .admission import Admission, AdmissionController, AdmissionPolicy
from .protocol import ProtocolError, Request, read_request, response_bytes
from .server import HttpServer
from .slo import RollingHistogram, SLOTracker

__all__ = [
    "Admission",
    "AdmissionController",
    "AdmissionPolicy",
    "ProtocolError",
    "Request",
    "read_request",
    "response_bytes",
    "HttpServer",
    "RollingHistogram",
    "SLOTracker",
]
