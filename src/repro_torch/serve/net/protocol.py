"""Minimal HTTP/1.1 framing over asyncio streams — stdlib only.

A copy of :mod:`repro.serve.net.protocol` for the PyTorch port.

The serving plane needs exactly enough HTTP to put the scheduler behind a
socket: request line + headers + ``Content-Length`` bodies in, status +
JSON bodies out, keep-alive by default.  Chunked transfer, trailers,
upgrades, and multipart are deliberately out of scope (501); anything
malformed maps to a :class:`ProtocolError` carrying the status code the
server should answer with, so framing errors and application errors travel
the same response path.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
from typing import Dict, Optional, Tuple
from urllib.parse import unquote

__all__ = ["Request", "ProtocolError", "read_request", "response_bytes",
           "json_body", "STATUS_REASONS", "MAX_BODY_BYTES"]

MAX_HEADER_BYTES = 32 * 1024
MAX_BODY_BYTES = 8 * 1024 * 1024

STATUS_REASONS = {
    200: "OK",
    204: "No Content",
    400: "Bad Request",
    404: "Not Found",
    405: "Method Not Allowed",
    408: "Request Timeout",
    411: "Length Required",
    413: "Payload Too Large",
    429: "Too Many Requests",
    431: "Request Header Fields Too Large",
    500: "Internal Server Error",
    501: "Not Implemented",
    503: "Service Unavailable",
    504: "Gateway Timeout",
}


class ProtocolError(Exception):
    """A request the server must answer with ``status`` (and drop the
    connection — framing state past the error is unrecoverable)."""

    def __init__(self, status: int, detail: str):
        super().__init__(detail)
        self.status = status
        self.detail = detail


@dataclasses.dataclass
class Request:
    method: str
    path: str          # decoded path, no query string
    query: str         # raw query string ('' when absent)
    headers: Dict[str, str]  # lower-cased field names
    body: bytes

    @property
    def keep_alive(self) -> bool:
        return self.headers.get("connection", "").lower() != "close"

    def json(self):
        """Decode the body as JSON; malformed bodies are 400s."""
        if not self.body:
            raise ProtocolError(400, "empty body where JSON was expected")
        try:
            return json.loads(self.body)
        except (ValueError, UnicodeDecodeError) as e:
            raise ProtocolError(400, f"malformed JSON body: {e}")


async def read_request(reader: asyncio.StreamReader,
                       max_body: int = MAX_BODY_BYTES) -> Optional[Request]:
    """Read one request; None on clean EOF (peer closed between requests)."""
    try:
        head = await reader.readuntil(b"\r\n\r\n")
    except asyncio.IncompleteReadError as e:
        if not e.partial:
            return None
        raise ProtocolError(400, "truncated request head")
    except asyncio.LimitOverrunError:
        raise ProtocolError(431, f"request head exceeds "
                                 f"{MAX_HEADER_BYTES} bytes")
    if len(head) > MAX_HEADER_BYTES:
        raise ProtocolError(431, f"request head exceeds {MAX_HEADER_BYTES} "
                                 f"bytes")
    lines = head[:-4].decode("latin-1").split("\r\n")
    parts = lines[0].split(" ")
    if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
        raise ProtocolError(400, f"malformed request line: {lines[0]!r}")
    method, target, _version = parts
    path, _, query = target.partition("?")
    headers: Dict[str, str] = {}
    for line in lines[1:]:
        name, sep, value = line.partition(":")
        if not sep or not name.strip():
            raise ProtocolError(400, f"malformed header line: {line!r}")
        headers[name.strip().lower()] = value.strip()
    if "transfer-encoding" in headers:
        raise ProtocolError(501, "chunked transfer encoding not supported")
    length = 0
    if "content-length" in headers:
        try:
            length = int(headers["content-length"])
        except ValueError:
            raise ProtocolError(400, "non-integer Content-Length")
        if length < 0:
            raise ProtocolError(400, "negative Content-Length")
    elif method in ("POST", "PUT", "PATCH"):
        raise ProtocolError(411, f"{method} requires Content-Length")
    if length > max_body:
        raise ProtocolError(413, f"body of {length} bytes exceeds the "
                                 f"{max_body}-byte limit")
    body = b""
    if length:
        try:
            body = await reader.readexactly(length)
        except asyncio.IncompleteReadError:
            raise ProtocolError(400, "connection closed mid-body")
    return Request(method, unquote(path), query, headers, body)


def response_bytes(status: int, body: object = None,
                   headers: Optional[Dict[str, str]] = None,
                   keep_alive: bool = True) -> bytes:
    """Serialize one response.  ``body`` may be bytes (sent as-is,
    ``text/plain``) or any JSON-serializable object."""
    if body is None:
        payload, ctype = b"", "text/plain"
    elif isinstance(body, (bytes, bytearray)):
        payload, ctype = bytes(body), "text/plain"
    else:
        payload = (json.dumps(body, separators=(",", ":")) + "\n").encode()
        ctype = "application/json"
    reason = STATUS_REASONS.get(status, "Unknown")
    out = [f"HTTP/1.1 {status} {reason}",
           f"Content-Type: {ctype}",
           f"Content-Length: {len(payload)}",
           f"Connection: {'keep-alive' if keep_alive else 'close'}"]
    for name, value in (headers or {}).items():
        out.append(f"{name}: {value}")
    return ("\r\n".join(out) + "\r\n\r\n").encode("latin-1") + payload


def json_body(status: int, obj: object,
              headers: Optional[Dict[str, str]] = None,
              keep_alive: bool = True) -> Tuple[int, bytes]:
    """(status, wire bytes) for a JSON response — the handler return shape."""
    return status, response_bytes(status, obj, headers, keep_alive)
