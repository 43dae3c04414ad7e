"""The port's router (chirrup_tpu_torch/server/router.py) over live sockets:
the five tests of tests/test_router.py against stub backends built on
server/http.py, the saturated pool asserted on what the router decides
rather than on a wall-clock ratio, and the router in front of two tiny port
servers on the CPU."""

import asyncio
import http.client
import json

import pytest

from chirrup_tpu_torch.engine.engine import build_model_factory
from chirrup_tpu_torch.engine.structures import ModelLoadConfig
from chirrup_tpu_torch.server.app import App
from chirrup_tpu_torch.server.config import ServerConfig
from chirrup_tpu_torch.server.http import Server, StreamResponse, json_response
from chirrup_tpu_torch.server.router import RouterApp

from tests.engine_fixtures import VOCAB_SIZE, write_tiny_vocab

HOST = "127.0.0.1"


class Stub:
    """A backend on server/http.py: GET /health and POST /v1/chat/completions
    (JSON echo, or `stream` server-sent events). `slots` bounds the requests
    it works on at once (the rest wait), `delay` is each event's wait, and
    `gate` (an asyncio.Event) holds every event after the first until set."""

    def __init__(self, name, slots=None, delay=0.0, events=3, gate=None):
        self.name, self.delay, self.events, self.gate = name, delay, events, gate
        self.sem = asyncio.Semaphore(slots) if slots else None
        self.requests = self.active = self.max_active = 0
        self.sent = []  # the SSE bytes of each stream, as written
        self.server = Server(self, {("GET", "/health"): self.health,
                                    ("POST", "/v1/chat/completions"): self.chat})

    async def start(self):
        self.port = await self.server.start(HOST, 0)
        self.url = f"http://{HOST}:{self.port}"
        return self

    async def health(self, request):
        return json_response({"status": "healthy", "backend": self.name})

    async def chat(self, request):
        self.requests += 1
        body = request.json()
        if self.sem is None:
            return await self._answer(request, body)
        async with self.sem:
            return await self._answer(request, body)

    async def _answer(self, request, body):
        self.active += 1
        self.max_active = max(self.max_active, self.active)
        try:
            if not body.get("stream"):
                await asyncio.sleep(self.delay)
                return json_response({"backend": self.name, "echo": body})
            resp = StreamResponse(headers={"Content-Type": "text/event-stream"})
            await resp.prepare(request)
            sent = b""
            for i in range(self.events):
                if i and self.gate is not None:
                    await self.gate.wait()
                await asyncio.sleep(self.delay)
                piece = f"data: {json.dumps({'backend': self.name, 'i': i})}\n\n".encode()
                await resp.write(piece)
                sent += piece
            await resp.write(b"data: [DONE]\n\n")
            await resp.write_eof()
            self.sent.append(sent + b"data: [DONE]\n\n")
            return resp
        finally:
            self.active -= 1


async def _call(port, method, path, body=None, timeout=60):
    """(status, body bytes) through http.client in a thread."""

    def go():
        conn = http.client.HTTPConnection(HOST, port, timeout=timeout)
        try:
            conn.request(method, path, body=None if body is None else json.dumps(body),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    return await asyncio.to_thread(go)


async def _stream(port, body, on_piece=None):
    """POST a stream request over a raw connection; the de-chunked body,
    each chunk handed to on_piece as it arrives."""
    reader, writer = await asyncio.open_connection(HOST, port)
    data = json.dumps(body).encode()
    writer.write(b"POST /v1/chat/completions HTTP/1.1\r\nHost: x\r\nContent-Type: "
                 b"application/json\r\nContent-Length: %d\r\n\r\n%s" % (len(data), data))
    await writer.drain()
    head = await reader.readuntil(b"\r\n\r\n")
    assert head.startswith(b"HTTP/1.1 200 ") and b"chunked" in head.lower(), head
    out = b""
    while True:
        size = int((await reader.readuntil(b"\r\n")).strip(), 16)
        piece = (await reader.readexactly(size + 2))[:-2]
        if size == 0:
            break
        out += piece
        if on_piece is not None:
            on_piece(piece)
    writer.close()
    return out


async def _with_router(stubs, go):
    for s in stubs:
        await s.start()
    app = RouterApp([s.url for s in stubs])
    port = await app.start(HOST, 0)
    try:
        return await go(port, app.router)
    finally:
        await app.close()
        for s in stubs:
            await s.server.close()


def _run(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def test_proxy_non_streaming_and_balance():
    """Six requests in a row are all answered with their echo; eight at once
    on backends that take 0.2 s are split four and four (least in flight)."""

    async def main():
        stubs = [Stub("b0", delay=0.2), Stub("b1", delay=0.2)]

        async def go(port, router):
            for i in range(6):
                status, body = await _call(port, "POST", "/v1/chat/completions", {"prompt": i})
                assert status == 200 and json.loads(body)["echo"] == {"prompt": i}
            assert stubs[0].requests + stubs[1].requests == 6
            before = [s.requests for s in stubs]
            res = await asyncio.gather(*[_call(port, "POST", "/v1/chat/completions", {"n": i})
                                         for i in range(8)])
            assert all(status == 200 for status, _ in res)
            return [s.requests - b for s, b in zip(stubs, before)]

        return await _with_router(stubs, go)

    assert _run(main()) == [4, 4]


def test_proxy_streaming_sse():
    """Server-sent events are relayed byte for byte and unbuffered: the
    backend writes its second event only after the client has read the
    first through the router."""

    async def main():
        gate = asyncio.Event()
        stubs = [Stub("b0", gate=gate, events=3)]

        async def go(port, router):
            pieces = []
            body = await _stream(port, {"stream": True},
                                 on_piece=lambda p: (pieces.append(p), gate.set()))
            return body, pieces

        body, pieces = await _with_router(stubs, go)
        return body, pieces, stubs[0].sent

    body, pieces, sent = _run(main())
    assert body == sent[0] and body.count(b"data: ") == 4 and body.endswith(b"data: [DONE]\n\n")
    assert pieces[0] == b'data: {"backend": "b0", "i": 0}\n\n'


def test_failover_to_healthy_backend():
    """With backend 0 gone, every request goes to backend 1, which answers."""

    async def main():
        stubs = [Stub("b0"), Stub("b1")]

        async def go(port, router):
            await stubs[0].server.close()
            out = [await _call(port, "POST", "/v1/chat/completions", {}) for _ in range(4)]
            return out, router.backends[0]

        return await _with_router(stubs, go)

    results, dead = _run(main())
    assert all(status == 200 for status, _ in results)
    assert all(json.loads(body)["backend"] == "b1" for _, body in results)
    assert not dead.healthy and dead.fail_count == 1 and dead.next_retry > 0


def test_aggregate_health():
    """/health probes each backend: 2 healthy, then 1 when one is closed
    (200 both times), then 503 with none."""

    async def main():
        stubs = [Stub("b0"), Stub("b1")]

        async def go(port, router):
            out = [await _call(port, "GET", "/health")]
            await stubs[1].server.close()
            out.append(await _call(port, "GET", "/health"))
            await stubs[0].server.close()
            out.append(await _call(port, "GET", "/health"))
            out.append(await _call(port, "POST", "/v1/chat/completions", {}))
            return out

        return await _with_router(stubs, go)

    (s1, b1), (s2, b2), (s3, b3), (s4, b4) = _run(main())
    assert s1 == 200 and json.loads(b1)["healthy_count"] == 2
    body2 = json.loads(b2)
    assert s2 == 200 and body2["healthy_count"] == 1
    assert str(body2["backends"][next(iter(body2["backends"]))]["status"]) == "200"
    assert s3 == 503 and json.loads(b3)["status"] == "unhealthy"
    err = json.loads(b4)["error"]
    assert s4 == 503 and (err["type"], err["code"]) == ("router_error", 503)


def test_router_under_saturated_backends():
    """Two backends of 8 slots each, 32 streams at once (twice their slots):
    every stream completes with its events in order, no backend ever works
    on more than its slots, every pick takes a backend with the fewest
    requests in flight, and the split is within one request."""
    SLOTS, EVENTS, N = 8, 10, 32

    async def main():
        stubs = [Stub(f"b{i}", slots=SLOTS, delay=0.005, events=EVENTS) for i in range(2)]
        picks = []

        async def go(port, router):
            pick = router.pick

            def recorded():
                loads = [b.inflight for b in router.backends]
                chosen = pick()
                picks.append((loads[router.backends.index(chosen)], min(loads)))
                return chosen

            router.pick = recorded
            return await asyncio.gather(*[_stream(port, {"stream": True, "n": i})
                                          for i in range(N)])

        bodies = await _with_router(stubs, go)
        return bodies, stubs, picks

    bodies, stubs, picks = _run(main(), timeout=120)
    for body in bodies:
        events = [json.loads(line[6:]) for line in body.decode().split("\n\n")
                  if line.startswith("data: {")]
        assert [e["i"] for e in events] == list(range(EVENTS))
        assert len({e["backend"] for e in events}) == 1
        assert body.endswith(b"data: [DONE]\n\n")
    assert all(s.max_active <= SLOTS for s in stubs)
    assert max(s.max_active for s in stubs) == SLOTS  # the pool was saturated
    assert len(picks) == N and all(chosen == least for chosen, least in picks)
    assert abs(stubs[0].requests - stubs[1].requests) <= 1
    assert stubs[0].requests + stubs[1].requests == N


@pytest.fixture(scope="module")
def vocab_path(tmp_path_factory):
    return write_tiny_vocab(str(tmp_path_factory.mktemp("vocab") / "vocab.txt"))


def test_router_in_front_of_two_port_servers(vocab_path):
    """Two port servers with the same synthetic weights behind the router:
    greedy chat completions through it, streamed and not, equal those sent
    straight to one server, and both servers take requests."""
    synthetic = dict(n_layer=2, n_embd=128, vocab_size=VOCAB_SIZE, d_decay_lora=32,
                     d_iclr_lora=32, d_v_lora=16, d_gate_lora=32)
    mc = ModelLoadConfig(model_path="<synthetic>", vocab_path=vocab_path,
                         vocab_size=VOCAB_SIZE, quantization=None, wkv_state_dtype="float32",
                         activation_dtype="float32", prefill_chunk=8,
                         synthetic_config=synthetic)
    chats = [{"messages": [{"role": "user", "content": f"hello world {i}"}],
              "max_tokens": 5, "temperature": 0.0, "ignore_eos": True,
              "use_state_cache": False, "stream": bool(i % 2)} for i in range(4)]

    def content(status, body):
        """The reply's text (reasoning and content), streamed or whole."""
        assert status == 200, body
        text = body.decode()
        if not text.startswith("data: "):
            msg = json.loads(text)["choices"][0]["message"]
            return (msg.get("reasoning_content") or "") + "|" + (msg.get("content") or "")
        deltas = [json.loads(line[6:])["choices"][0]["delta"] for line in text.split("\n\n")
                  if line.startswith("data: {")]
        return ("".join(d.get("reasoning_content") or "" for d in deltas) + "|"
                + "".join(d.get("content") or "" for d in deltas))

    async def main():
        apps = []
        for _ in range(2):
            app = App(ServerConfig(vocab_path=vocab_path, vocab_size=VOCAB_SIZE, batch_size=4,
                                   state_cache_size=0, quantization="none", device="cpu"),
                      model_factory=build_model_factory(mc, batch_size=4, device="cpu"))
            app.port = await app.start(HOST, 0)
            await app.load()
            apps.append(app)
        router = RouterApp([f"http://{HOST}:{a.port}" for a in apps])
        rport = await router.start(HOST, 0)
        try:
            direct = [content(*await _call(apps[0].port, "POST", "/v1/chat/completions", c))
                      for c in chats]
            served = [len(a.ttft_samples) for a in apps]
            routed = await asyncio.gather(*[_call(rport, "POST", "/v1/chat/completions", c)
                                            for c in chats])
            routed = [content(*r) for r in routed]
            moved = [len(a.ttft_samples) - s for a, s in zip(apps, served)]
            return direct, routed, moved
        finally:
            await router.close()
            for a in apps:
                await a.close()

    direct, routed, moved = _run(main(), timeout=240)
    assert all(d != "|" for d in direct) and routed == direct
    assert all(m > 0 for m in moved)


def test_router_and_multihost_modules_import_no_foreign_package():
    """The router, the hosts' vote group and the dry run load with jax,
    chirrup_tpu and aiohttp blocked."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys\n"
        "blocked = ('jax', 'chirrup_tpu', 'aiohttp')\n"
        "for m in blocked:\n"
        "    sys.modules[m] = None\n"
        "import chirrup_tpu_torch.server.router, chirrup_tpu_torch.parallel.hosts\n"
        "import chirrup_tpu_torch.parallel.dryrun_multihost, chirrup_tpu_torch.engine.engine\n"
        "bad = [m for m, v in sys.modules.items() if v is not None\n"
        "       and m.split('.')[0] in blocked]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=repo))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
