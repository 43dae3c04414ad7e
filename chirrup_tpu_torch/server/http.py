"""A small HTTP/1.1 server on asyncio streams: the server's stand-in for
aiohttp (the standard library only).

What it does, and nothing more:
- requests: GET (and HEAD), POST and OPTIONS; the body read by
  Content-Length (at most MAX_BODY bytes, as aiohttp's default
  client_max_size; `Expect: 100-continue` answered); keep-alive;
- responses: `Response` (a whole body with its length) and `StreamResponse`
  (a head, then chunks: server-sent events and long JSON bodies);
- the JAX server's middleware behaviour (chirrup_tpu/server/app.py
  cors_and_errors_middleware): CORS headers on every response, OPTIONS
  answered with an empty 200, and the OpenAI error envelope: an HTTPError
  (404 and 405 from routing too) -> invalid_request_error with its status,
  an api_models.ValidationError -> 422, a body that is not JSON -> 400,
  anything else -> 500 internal_server_error;
- a client that hangs up while its request runs: the handler's task is
  cancelled, so CancelledError reaches the handler at its next await and
  its `finally` blocks (which abort completions) run.
"""

from __future__ import annotations

import asyncio
import http
import json
import traceback
from typing import Any, Awaitable, Callable, Dict, Optional, Tuple
from urllib.parse import urlsplit

from chirrup_tpu_torch.server.api_models import ValidationError

KEEPALIVE_SECONDS = 10.0
SSE_KEEPALIVE = b": keep-alive\n\n"
MAX_BODY = 1 << 20
MAX_HEAD = 64 << 10

CORS_HEADERS = {
    "Access-Control-Allow-Origin": "*",
    "Access-Control-Allow-Methods": "*",
    "Access-Control-Allow-Headers": "*",
}


def dumps(obj) -> str:
    """Compact JSON, non-ASCII characters kept (pydantic's model_dump_json)."""
    return json.dumps(obj, ensure_ascii=False, separators=(",", ":"))


def error_json(message: str, err_type: str, code: Optional[int] = None) -> Dict:
    err: Dict[str, Any] = {"message": message, "type": err_type}
    if code is not None:
        err["code"] = code
    return {"error": err}


class HTTPError(Exception):
    """Raise in a handler to answer `status` with the error envelope."""

    def __init__(self, status: int, reason: Optional[str] = None):
        self.status = status
        self.reason = reason or http.HTTPStatus(status).phrase
        super().__init__(self.reason)


class Request:
    def __init__(self, app, method: str, target: str, version: str,
                 headers: Dict[str, str], body: bytes):
        self.app = app
        self.method = method
        self.path = urlsplit(target).path
        self.version = version
        self.headers = headers  # names lower-cased
        self.body = body
        self.writer: Optional[asyncio.StreamWriter] = None
        self.prepared = False  # a StreamResponse has sent its head

    def json(self):
        """The body as JSON (json.JSONDecodeError when it is not)."""
        return json.loads(self.body.decode("utf-8", errors="replace"))

    @property
    def keep_alive(self) -> bool:
        conn = self.headers.get("connection", "").lower()
        return conn != "close" if self.version == "HTTP/1.1" else conn == "keep-alive"


def _head(status: int, headers: Dict[str, str]) -> bytes:
    lines = [f"HTTP/1.1 {status} {http.HTTPStatus(status).phrase}"]
    lines += [f"{k}: {v}" for k, v in {**headers, **CORS_HEADERS}.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


class Response:
    """A whole response, sent with its Content-Length."""

    def __init__(self, body: bytes = b"", status: int = 200,
                 headers: Optional[Dict[str, str]] = None,
                 content_type: str = "application/octet-stream"):
        self.body, self.status = body, status
        self.headers = {"Content-Type": content_type, **(headers or {})}

    async def send(self, writer: asyncio.StreamWriter, keep_alive: bool,
                   head_only: bool = False) -> None:
        headers = {**self.headers, "Content-Length": str(len(self.body)),
                   "Connection": "keep-alive" if keep_alive else "close"}
        writer.write(_head(self.status, headers) + (b"" if head_only else self.body))
        await writer.drain()


def json_response(data, status: int = 200) -> Response:
    return Response(dumps(data).encode(), status=status,
                    content_type="application/json; charset=utf-8")


class StreamResponse:
    """A head, then the body in chunks (Transfer-Encoding: chunked). write()
    raises ConnectionResetError once the client has gone."""

    def __init__(self, status: int = 200, headers: Optional[Dict[str, str]] = None):
        self.status = status
        self.headers = dict(headers or {})
        self._writer: Optional[asyncio.StreamWriter] = None

    async def prepare(self, request: Request) -> None:
        self._writer = request.writer
        self.headers.setdefault("Connection",
                                "keep-alive" if request.keep_alive else "close")
        self._writer.write(_head(self.status, {**self.headers,
                                               "Transfer-Encoding": "chunked"}))
        request.prepared = True
        await self._writer.drain()

    async def write(self, data: bytes) -> None:
        if data:
            self._writer.write(b"%x\r\n%s\r\n" % (len(data), data))
            await self._writer.drain()

    async def write_eof(self) -> None:
        self._writer.write(b"0\r\n\r\n")
        await self._writer.drain()


Handler = Callable[[Request], Awaitable[Any]]


class _BadRequest(Exception):
    def __init__(self, status: int, message: str):
        self.status, self.message = status, message


class _Connection:
    """One client socket: request parsing over a buffer that also holds what
    arrived while the previous response was running."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader, self.writer = reader, writer
        self.buf = bytearray()

    async def _fill(self) -> bool:
        data = await self.reader.read(65536)
        self.buf += data
        return bool(data)

    async def read_head(self) -> Optional[bytes]:
        while True:
            end = self.buf.find(b"\r\n\r\n")
            if end >= 0:
                head = bytes(self.buf[:end])
                del self.buf[:end + 4]
                return head
            if len(self.buf) > MAX_HEAD:
                raise _BadRequest(431, "request head too large")
            if not await self._fill():
                if self.buf.strip():
                    raise _BadRequest(400, "incomplete request head")
                return None

    async def read_body(self, n: int) -> bytes:
        while len(self.buf) < n:
            if not await self._fill():
                raise ConnectionResetError("client closed inside a request body")
        body = bytes(self.buf[:n])
        del self.buf[:n]
        return body

    async def watch_hangup(self) -> None:
        """Returns when the client closes; keeps what else it sends."""
        try:
            while await self._fill():
                pass
        except ConnectionError:
            pass


class Server:
    """Routes {(method, path): handler}; `app` is what request.app gives."""

    def __init__(self, app, routes: Dict[Tuple[str, str], Handler]):
        self.app = app
        self.routes = routes
        self.paths = {path for _, path in routes}
        self._server: Optional[asyncio.base_events.Server] = None
        self._writers: set = set()

    async def start(self, host: str, port: int) -> int:
        """Bind and serve; returns the bound port (port 0: a free one)."""
        self._server = await asyncio.start_server(self._connection, host, port)
        return self._server.sockets[0].getsockname()[1]

    async def close(self) -> None:
        if self._server is None:
            return
        self._server.close()
        for w in list(self._writers):
            w.close()
        await self._server.wait_closed()

    async def _connection(self, reader, writer) -> None:
        conn = _Connection(reader, writer)
        self._writers.add(writer)
        try:
            while True:
                try:
                    request = await self._read_request(conn)
                except _BadRequest as exc:
                    await json_response(error_json(exc.message, "invalid_request_error",
                                                   exc.status),
                                        status=exc.status).send(writer, keep_alive=False)
                    break
                if request is None or not await self._serve(conn, request):
                    break
        except ConnectionError:
            pass
        finally:
            self._writers.discard(writer)
            writer.close()

    async def _read_request(self, conn: _Connection) -> Optional[Request]:
        head = await conn.read_head()
        if head is None:
            return None
        try:
            lines = head.decode("latin-1").split("\r\n")
            method, target, version = lines[0].split(" ")
            headers = {}
            for line in lines[1:]:
                name, value = line.split(":", 1)
                headers[name.strip().lower()] = value.strip()
            length = int(headers.get("content-length", "0"))
        except ValueError:
            raise _BadRequest(400, "malformed request head") from None
        if "chunked" in headers.get("transfer-encoding", "").lower():
            raise _BadRequest(411, "a request body needs a Content-Length")
        if length > MAX_BODY:
            raise _BadRequest(413, f"request body of {length} bytes exceeds {MAX_BODY}")
        if length and headers.get("expect", "").lower() == "100-continue":
            conn.writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
        body = await conn.read_body(length)
        request = Request(self.app, method.upper(), target, version, headers, body)
        request.writer = conn.writer
        return request

    async def _serve(self, conn: _Connection, request: Request) -> bool:
        """Run one request to its response; False when the connection ends."""
        handler = asyncio.create_task(self._respond(request))
        watcher = asyncio.create_task(conn.watch_hangup())
        done, _ = await asyncio.wait({handler, watcher},
                                     return_when=asyncio.FIRST_COMPLETED)
        if handler not in done:  # the client hung up first
            handler.cancel()
            try:
                await handler
            except (asyncio.CancelledError, ConnectionError):
                pass
            return False
        watcher.cancel()
        try:
            await watcher
        except asyncio.CancelledError:
            pass
        resp = handler.result()
        if isinstance(resp, Response) and not request.prepared:
            await resp.send(conn.writer, request.keep_alive,
                            head_only=request.method == "HEAD")
        elif not isinstance(resp, StreamResponse):
            return False  # a response broke off after its head went out
        return request.keep_alive

    async def _respond(self, request: Request):
        if request.method == "OPTIONS":
            return Response()
        method = "GET" if request.method == "HEAD" else request.method
        handler = self.routes.get((method, request.path))
        try:
            if handler is None:
                raise HTTPError(405 if request.path in self.paths else 404)
            return await handler(request)
        except HTTPError as exc:
            return json_response(error_json(exc.reason, "invalid_request_error",
                                            exc.status), status=exc.status)
        except ValidationError as exc:
            return json_response(error_json(str(exc), "invalid_request_error", 422),
                                 status=422)
        except json.JSONDecodeError as exc:
            return json_response(error_json(f"invalid JSON body: {exc}",
                                            "invalid_request_error", 400), status=400)
        except ConnectionError:
            return None
        except Exception as exc:  # noqa: BLE001 — the OpenAI-style error envelope
            traceback.print_exc()
            return json_response(error_json(str(exc), "internal_server_error", 500),
                                 status=500)
