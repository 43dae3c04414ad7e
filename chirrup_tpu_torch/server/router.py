"""Multi-host data-parallel router: one front door over N serving hosts.

The port of chirrup_tpu/server/router.py on the standard library: the front
end is server/http.py, the backend client HTTP/1.1 on
asyncio.open_connection (Content-Length, chunked and read-to-close bodies).
Each backend is a `python -m chirrup_tpu_torch.server` with a whole
(possibly tensor-parallel) replica; decode work never crosses hosts, so the
router's own costs are the only shared ones.

- least-loaded routing: the backend with the fewest requests in flight,
  ties broken by fail count;
- passive health: a backend that fails is skipped for 2^n s (at most 30 s)
  after its n-th failure in a row;
- a connection error before any byte has gone to the client retries the
  request on the next backend; after that the client's connection breaks
  off (the response cannot be restarted);
- the upstream body is relayed piece by piece as it arrives, so server-sent
  events are not buffered; hop-by-hop headers are dropped both ways;
- GET /health probes every backend's /health (5 s each) and answers 503
  when none is healthy; a request with no backend to take it gets 503 with
  the `router_error` JSON.

    python -m chirrup_tpu_torch.server.router \\
        --backends http://host0:8000,http://host1:8000 --port 9000
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal
import sys
import time
from typing import AsyncIterator, Dict, List, Optional, Tuple
from urllib.parse import urlsplit

from chirrup_tpu_torch.server.http import (
    CORS_HEADERS, Request, Response, Server, StreamResponse, error_json, json_response)

log = logging.getLogger(__name__)

HOP_HEADERS = {"host", "content-length", "transfer-encoding", "connection", "keep-alive"}
# the front end adds these to every response itself
_OWN_HEADERS = HOP_HEADERS | {k.lower() for k in CORS_HEADERS}
CONNECT_TIMEOUT = 10.0
HEALTH_TIMEOUT = 5.0
MAX_BACKOFF = 30.0


class UpstreamError(ConnectionError):
    """A backend's response that cannot be read (malformed or cut short)."""


class Backend:
    def __init__(self, url: str):
        self.url = url.rstrip("/")
        parts = urlsplit(self.url)
        if parts.scheme != "http" or not parts.hostname:
            raise ValueError(f"backend {url!r}: an http://host:port URL")
        self.host = parts.hostname
        self.port = parts.port or 80
        self.netloc = parts.netloc
        self.prefix = parts.path
        self.inflight = 0
        self.healthy = True
        self.next_retry = 0.0
        self.fail_count = 0

    def mark_failed(self) -> None:
        self.fail_count += 1
        self.healthy = False
        self.next_retry = time.time() + min(2.0 ** self.fail_count, MAX_BACKOFF)

    def mark_ok(self) -> None:
        self.fail_count = 0
        self.healthy = True


# ------------------------------------------------------------ backend client

async def _read_head(reader: asyncio.StreamReader) -> Tuple[int, List[Tuple[str, str]]]:
    """A response's status and headers (names as sent)."""
    try:
        raw = await reader.readuntil(b"\r\n\r\n")
    except asyncio.IncompleteReadError as exc:
        raise UpstreamError("backend closed before its response head") from exc
    except asyncio.LimitOverrunError as exc:
        raise UpstreamError("backend response head too large") from exc
    lines = raw[:-4].decode("latin-1").split("\r\n")
    try:
        status = int(lines[0].split(" ", 2)[1])
        headers = []
        for line in lines[1:]:
            name, value = line.split(":", 1)
            headers.append((name.strip(), value.strip()))
    except (IndexError, ValueError) as exc:
        raise UpstreamError(f"malformed backend response head {lines[0]!r}") from exc
    return status, headers


async def _body(reader: asyncio.StreamReader, headers: Dict[str, str]) -> AsyncIterator[bytes]:
    """The response body's pieces as they arrive: chunked, by Content-Length,
    or to the end of the connection."""
    try:
        if "chunked" in headers.get("transfer-encoding", "").lower():
            while True:
                size = int((await reader.readuntil(b"\r\n")).split(b";")[0].strip(), 16)
                if size == 0:
                    while await reader.readuntil(b"\r\n") != b"\r\n":
                        pass  # trailers
                    return
                data = await reader.readexactly(size + 2)
                yield data[:-2]
        elif "content-length" in headers:
            left = int(headers["content-length"])
            while left > 0:
                data = await reader.read(min(left, 65536))
                if not data:
                    raise UpstreamError("backend closed inside its response body")
                left -= len(data)
                yield data
        else:
            while data := await reader.read(65536):
                yield data
    except (asyncio.IncompleteReadError, asyncio.LimitOverrunError, ValueError) as exc:
        raise UpstreamError(f"malformed backend response body: {exc}") from exc


async def _open(backend: Backend, method: str, target: str, headers: Dict[str, str],
                body: bytes):
    """Send one request (Connection: close); the reader and writer, and the
    response's status and headers."""
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(backend.host, backend.port), CONNECT_TIMEOUT)
    try:
        lines = [f"{method} {backend.prefix}{target} HTTP/1.1", f"Host: {backend.netloc}"]
        lines += [f"{k}: {v}" for k, v in headers.items() if k.lower() not in HOP_HEADERS]
        lines += [f"Content-Length: {len(body)}", "Connection: close"]
        writer.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + body)
        await writer.drain()
        status, resp_headers = await _read_head(reader)
    except BaseException:
        writer.close()
        raise
    return reader, writer, status, resp_headers


# -------------------------------------------------------------------- router

class Router:
    def __init__(self, backends: List[str]):
        self.backends = [Backend(u) for u in backends]

    def pick(self) -> Optional[Backend]:
        now = time.time()
        candidates = [b for b in self.backends if b.healthy or now >= b.next_retry]
        if not candidates:
            return None
        return min(candidates, key=lambda b: (b.inflight, b.fail_count))

    async def proxy(self, request: Request):
        last_error = None
        for _ in range(len(self.backends)):
            backend = self.pick()
            if backend is None:
                break
            backend.inflight += 1
            try:
                return await self._forward(request, backend)
            except (OSError, asyncio.TimeoutError) as exc:
                backend.mark_failed()
                if request.prepared:
                    raise  # bytes went out: the client's connection breaks off
                last_error = exc
            finally:
                backend.inflight -= 1
        return json_response(error_json(f"no healthy backend: {last_error}", "router_error",
                                        503), status=503)

    async def _forward(self, request: Request, backend: Backend) -> StreamResponse:
        reader, writer, status, headers = await _open(
            backend, request.method, request.target, request.headers, request.body)
        try:
            backend.mark_ok()
            resp = StreamResponse(status=status, headers={
                k: v for k, v in headers if k.lower() not in _OWN_HEADERS})
            await resp.prepare(request)
            if request.method != "HEAD" and status not in (204, 304):
                async for piece in _body(reader, {k.lower(): v for k, v in headers}):
                    await resp.write(piece)
            await resp.write_eof()
            return resp
        finally:
            writer.close()

    async def _probe(self, backend: Backend) -> int:
        reader, writer, status, headers = await _open(backend, "GET", "/health", {}, b"")
        try:
            async for _ in _body(reader, {k.lower(): v for k, v in headers}):
                pass
        finally:
            writer.close()
        return status

    async def health(self, request: Request) -> Response:
        """Aggregate backend health (actively probes each /health)."""
        results = {}
        for b in self.backends:
            try:
                status = await asyncio.wait_for(self._probe(b), HEALTH_TIMEOUT)
                results[b.url] = {"status": status, "inflight": b.inflight}
                b.mark_ok()
            except (OSError, asyncio.TimeoutError) as exc:
                results[b.url] = {"status": f"error: {exc!r}", "inflight": b.inflight}
                b.mark_failed()
        healthy = sum(1 for v in results.values() if v["status"] == 200)
        return json_response({
            "status": "healthy" if healthy else "unhealthy",
            "backends": results,
            "healthy_count": healthy,
        }, status=200 if healthy else 503)


class RouterApp:
    """The router behind server/http.py: /health, and every other request
    proxied. start() binds it (port 0: a free one)."""

    def __init__(self, backends: List[str]):
        self.router = Router(backends)

        async def proxy(request: Request):
            return await self.router.proxy(request)

        async def health(request: Request):
            return await self.router.health(request)

        self.server = Server(self, {("GET", "/health"): health}, fallback=proxy)

    async def start(self, host: str, port: int) -> int:
        return await self.server.start(host, port)

    async def close(self) -> None:
        await self.server.close()


async def serve(backends: List[str], host: str, port: int) -> int:
    """Serve until SIGINT or SIGTERM; the exit code."""
    app = RouterApp(backends)
    bound = await app.start(host, port)
    log.info("listening on http://%s:%d; routing over %s", host, bound,
             ",".join(b.url for b in app.router.backends))
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    await app.close()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="chirrup_tpu_torch.server.router")
    ap.add_argument("--backends", required=True, help="comma-separated backend base URLs")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=9000)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    return asyncio.run(serve([u for u in args.backends.split(",") if u], args.host, args.port))


if __name__ == "__main__":
    sys.exit(main())
