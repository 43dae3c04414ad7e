"""The port's OpenAI-compatible server over a real socket, with a stdlib
client and a synthetic model on the CPU: one counterpart of each test of
tests/test_server.py (status codes and error type/code as the JAX server's),
parity with the JAX server on the same weights, the prefix cache's server
half (resumed-prefix keys, one snapshot per dedup group), a client hang-up
aborting its completion, the entry point, and the import rule."""

import asyncio
import concurrent.futures
import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from chirrup_tpu_torch.engine.engine import build_model_factory
from chirrup_tpu_torch.engine.state_cache import PrefixStateCache
from chirrup_tpu_torch.engine.structures import ModelLoadConfig, RequestState, RequestStatus
from chirrup_tpu_torch.server import app as app_mod
from chirrup_tpu_torch.server.app import App, _cache_event
from chirrup_tpu_torch.server.config import PROFILES, ServerConfig, parse_config

from tests.engine_fixtures import VOCAB_SIZE, synthetic_model_config, write_tiny_vocab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTHETIC = dict(n_layer=2, n_embd=128, vocab_size=VOCAB_SIZE, d_decay_lora=32,
                 d_iclr_lora=32, d_v_lora=16, d_gate_lora=32)


def _model_config(vocab_path):
    return ModelLoadConfig(model_path="<synthetic>", vocab_path=vocab_path,
                           vocab_size=VOCAB_SIZE, quantization=None,
                           wkv_state_dtype="float32", activation_dtype="float32",
                           prefill_chunk=8, synthetic_config=SYNTHETIC)


class Running:
    """An App served from an event loop on a thread of its own."""

    def __init__(self, app, load=True):
        self.app = app
        self.loop = asyncio.new_event_loop()
        self.port = self.loop.run_until_complete(app.start("127.0.0.1", 0))
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        if load:
            self.call(app.load(), 240)

    def call(self, coro, timeout=120):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout)

    def close(self):
        self.call(self.app.close(), 60)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()
        self.loop.close()


def request(port, method, path, body=None, raw=False, headers=None, timeout=120):
    """(status, headers, body bytes) over one connection."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        data = body if raw or body is None else json.dumps(body)
        conn.request(method, path, body=data,
                     headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return resp.status, resp.headers, resp.read()
    finally:
        conn.close()


@pytest.fixture(scope="module")
def vocab_path(tmp_path_factory):
    return write_tiny_vocab(str(tmp_path_factory.mktemp("vocab") / "vocab.txt"))


@pytest.fixture(scope="module")
def server(vocab_path):
    config = ServerConfig(vocab_path=vocab_path, vocab_size=VOCAB_SIZE, worker_num=1,
                          batch_size=4, state_cache_size=10, quantization="none",
                          device="cpu")
    app = App(config, model_factory=build_model_factory(
        _model_config(vocab_path), batch_size=4, device="cpu"))
    srv = Running(app)
    yield srv
    srv.close()


@pytest.fixture
def recorded(server, monkeypatch):
    """Every completion the engine creates, with its keyword arguments."""
    made = []
    engine = server.app.engine
    original = engine.completion

    def completion(*args, **kwargs):
        comp = original(*args, **kwargs)
        made.append((comp, kwargs))
        return comp

    monkeypatch.setattr(engine, "completion", completion)
    return made


# ------------------------------------------- counterparts of tests/test_server.py


def test_health(server):
    status, _, body = request(server.port, "GET", "/health")
    body = json.loads(body)
    assert status == 200
    assert body["status"] == "healthy" and body["model_loaded"]


def test_models(server):
    body = json.loads(request(server.port, "GET", "/v1/models")[2])
    assert [m["id"] for m in body["data"]] == [
        "rwkv-latest", "rwkv-latest:thinking", "rwkv-latest:no-thinking"]
    assert body["object"] == "list"


def test_chat_completion_non_stream(server):
    status, _, body = request(server.port, "POST", "/v1/chat/completions", {
        "model": "rwkv-latest:no-thinking",
        "messages": [{"role": "user", "content": "hello world"}],
        "max_tokens": 5, "temperature": 0.0,
        "use_state_cache": False, "cache_prefill": False})
    body = json.loads(body)
    assert status == 200
    assert body["object"] == "chat.completion"
    choice = body["choices"][0]
    assert choice["message"]["role"] == "assistant"
    assert isinstance(choice["message"]["content"], str)
    assert body["usage"]["prompt_tokens"] > 0


def test_chat_completion_stream_sse(server):
    status, headers, raw = request(server.port, "POST", "/v1/chat/completions", {
        "model": "rwkv-latest:no-thinking",
        "messages": [{"role": "user", "content": "hello"}],
        "max_tokens": 6, "temperature": 1.0, "top_p": 0.9, "stream": True,
        "use_state_cache": False, "cache_prefill": False})
    assert status == 200
    assert headers["Content-Type"].startswith("text/event-stream")
    assert headers["Cache-Control"] == "no-cache" and headers["X-Accel-Buffering"] == "no"
    lines = [l for l in raw.decode().split("\n") if l.startswith("data: ")]
    assert lines[-1] == "data: [DONE]"
    payloads = [json.loads(l[6:]) for l in lines[:-1]]
    assert all(p["object"] == "chat.completion.chunk" for p in payloads)
    final = payloads[-1]
    assert final["choices"][0]["finish_reason"] in ("stop", "length")
    usage = final["usage"]
    assert 1 <= usage["completion_tokens"] <= 6
    assert usage["total_tokens"] == usage["prompt_tokens"] + usage["completion_tokens"]
    assert all(p["usage"] is None for p in payloads[:-1])


def test_state_cache_population_and_reuse(server):
    body = {"model": "rwkv-latest",  # quick-thinking template, padding 7
            "messages": [{"role": "user", "content": "the world says hello again"}],
            "max_tokens": 3, "temperature": 0.0}
    t1 = json.loads(request(server.port, "POST", "/v1/chat/completions", body)[2])
    cache_len = len(server.app.state_cache)
    t2 = json.loads(request(server.port, "POST", "/v1/chat/completions", body)[2])
    assert cache_len >= 1  # the first request populated the prefix cache
    # greedy + same prompt + cache-resume must give identical text
    assert t1["choices"][0]["message"] == t2["choices"][0]["message"]


def test_rollout_non_stream(server):
    body = json.loads(request(server.port, "POST", "/v1/batch/rollout", {
        "contents": ["hello world", "the User"], "max_tokens": 4, "temperature": 0.5,
        "stop_tokens": [0]})[2])
    assert body["object"] == "batch.rollout.chunk"
    assert len(body["rollouts"]) == 2
    for i, r in enumerate(body["rollouts"]):
        assert r["index"] == i
        assert isinstance(r["delta"]["content"], str)


def test_rollout_stream(server):
    status, headers, raw = request(server.port, "POST", "/v1/batch/rollout", {
        "contents": ["hello", "world"], "max_tokens": 3, "temperature": 1.0,
        "stop_tokens": [0], "stream": True})
    assert status == 200 and headers["Content-Type"] == "text/event-stream"
    datas = [json.loads(l[6:]) for l in raw.decode().split("\n")
             if l.startswith("data: ") and l != "data: [DONE]"]
    assert datas and all(d["object"] == "batch.rollout.chunk" for d in datas)
    assert {c["index"] for d in datas for c in d["choices"]} <= {0, 1}


def test_translate(server):
    body = json.loads(request(server.port, "POST", "/v1/batch/translate", {
        "source_lang": "en", "target_lang": "zh-CN", "text_list": ["hello"]},
        timeout=180)[2])
    assert len(body["translations"]) == 1
    assert body["translations"][0]["detected_source_lang"] == "en"


def test_validation_error_envelope(server):
    status, _, body = request(server.port, "POST", "/v1/chat/completions", {"model": "x"})
    assert status == 422
    assert json.loads(body)["error"]["type"] == "invalid_request_error"
    assert json.loads(body)["error"]["code"] == 422


def test_cors_headers(server):
    _, headers, _ = request(server.port, "GET", "/health")
    assert headers["Access-Control-Allow-Origin"] == "*"
    status, headers, body = request(server.port, "OPTIONS", "/v1/chat/completions")
    assert status == 200 and body == b""
    assert headers["Access-Control-Allow-Methods"] == "*"
    assert headers["Access-Control-Allow-Headers"] == "*"


def test_no_thinking_repeat_prompt_padding_zero(server):
    """The :no-thinking template (padding 0): a repeated prompt resumes from
    the full-prefix snapshot and gives the same greedy text."""
    body = {"model": "rwkv-latest:no-thinking",
            "messages": [{"role": "user",
                          "content": "hello world hello world again and again"}],
            "stream": False, "max_tokens": 3, "ignore_eos": True, "temperature": 0.0}
    out = []
    for _ in range(2):
        status, _, data = request(server.port, "POST", "/v1/chat/completions", body)
        assert status == 200
        out.append(json.loads(data)["choices"][0]["message"]["content"])
    assert out[0] == out[1]


def test_ignore_eos_runs_to_max_tokens(server):
    status, _, data = request(server.port, "POST", "/v1/chat/completions", {
        "model": "rwkv-latest:no-thinking",
        "messages": [{"role": "user", "content": "count"}],
        "stream": False, "max_tokens": 7, "ignore_eos": True, "temperature": 1.0,
        "top_p": 1.0, "use_state_cache": False, "cache_prefill": False})
    data = json.loads(data)
    assert status == 200
    assert data["usage"]["completion_tokens"] == 7
    assert data["choices"][0]["finish_reason"] == "length"


MALFORMED = [
    '{"messages": "not a list"}',
    '{"messages": [{"role": "user"}]}',              # missing content
    '{"messages": [], "max_tokens": "many"}',
    'not json at all',
    '{"messages": [{"role": "user", "content": "x"}], "temperature": -99,'
    ' "top_p": 99, "max_tokens": 1, "ignore_eos": true}',  # out of bounds
    '{"messages": [{"role": "user", "content": "x"}],'
    ' "stop": [123], "max_tokens": 1}',              # stop: wrong item type
    '[1, 2]',
    '{"messages": [{"role": "user", "content": "x"}], "max_tokens": 0}',
]


def test_malformed_requests_error_envelopes(server):
    """Malformed bodies produce OpenAI-style error JSON and never hang or
    crash the server; the status of each is the JAX server's (checked
    against it in test_error_envelopes_match_jax_server)."""
    expected = [422, 422, 422, 400, 422, 422, 422, 422]
    for b, want in zip(MALFORMED, expected):
        status, _, text = request(server.port, "POST", "/v1/chat/completions", b, raw=True)
        err = json.loads(text)["error"]
        assert (status, err["type"], err["code"]) == (want, "invalid_request_error", want)
    status, _, _ = request(server.port, "POST", "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hi"}], "max_tokens": 2,
        "ignore_eos": True})
    assert status == 200


def test_metrics_endpoint(server):
    status, _, _ = request(server.port, "POST", "/v1/chat/completions", {
        "model": "rwkv-latest:no-thinking",
        "messages": [{"role": "user", "content": "hello"}],
        "stream": False, "max_tokens": 2, "temperature": 0.0})
    assert status == 200
    time.sleep(0.2)  # let the perf collector drain an event
    status, _, body = request(server.port, "GET", "/metrics")
    body = json.loads(body)
    assert status == 200
    assert "workers" in body and "state_cache" in body
    assert body["tokenizer"] == "c"
    # kernel launches since loading: the CPU runs the plain versions only
    assert body["kernel_launches"] and not any(body["kernel_launches"].values())
    if body["workers"]:
        perf = next(iter(body["workers"].values()))
        assert "avg_loop_time" in perf and "task_details" in perf
    bd = body["ttft_breakdown"]
    assert bd is not None and bd["n"] >= 1
    assert 0 <= bd["queue_wait_p50_s"] < 60
    assert 0 <= bd["compute_wait_p50_s"] < 60


# ----------------------------------------------------- routing and HTTP layer


def test_routing_errors_and_keep_alive(server):
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
    try:
        for method, path, want in (("GET", "/nope", 404), ("POST", "/health", 405),
                                   ("GET", "/v1/chat/completions", 405),
                                   ("GET", "/health", 200), ("HEAD", "/health", 200)):
            conn.request(method, path)  # one connection: keep-alive
            resp = conn.getresponse()
            body = resp.read()
            assert resp.status == want, (method, path)
            if want != 200:
                err = json.loads(body)["error"]
                assert (err["type"], err["code"]) == ("invalid_request_error", want)
            elif method == "HEAD":
                assert body == b"" and int(resp.headers["Content-Length"]) > 0
    finally:
        conn.close()


def test_oversized_and_expect_continue(server):
    status, _, body = request(server.port, "POST", "/v1/chat/completions",
                              b"x" * ((1 << 20) + 1), raw=True)
    assert status == 413 and json.loads(body)["error"]["code"] == 413
    status, _, body = request(server.port, "POST", "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hi " * 20}], "max_tokens": 1,
        "use_state_cache": False, "cache_prefill": False},
        headers={"Expect": "100-continue"})
    assert status == 200 and json.loads(body)["usage"]["completion_tokens"] == 1


def test_health_is_503_until_loaded(vocab_path):
    """The server binds first: /health answers 503 and a completion 503
    until the engine is loaded."""
    srv = Running(App(ServerConfig(vocab_path=vocab_path, device="cpu")), load=False)
    try:
        status, _, body = request(srv.port, "GET", "/health")
        assert status == 503 and json.loads(body)["status"] == "loading"
        status, _, body = request(srv.port, "POST", "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "x"}]})
        err = json.loads(body)["error"]
        assert status == 503 and (err["type"], err["code"]) == ("invalid_request_error", 503)
    finally:
        srv.close()


# -------------------------------------------------------- the JAX server, same weights


def test_parity_with_jax_server(vocab_path, server):
    """The same greedy chat completion from the JAX server (aiohttp
    TestClient) and the port's, on the JAX server's worker-0 weights carried
    across with params_from_numpy; and the same status and error type/code
    for every malformed body."""
    import jax
    from aiohttp.test_utils import TestClient, TestServer

    from chirrup_tpu.engine.engine import build_model_factory as j_factory
    from chirrup_tpu.models.config import RWKV7Config as JConfig
    from chirrup_tpu.models.loader import synthetic_params as j_synthetic_params
    from chirrup_tpu.server.app import create_app as j_create_app
    from chirrup_tpu.server.config import ServerConfig as JServerConfig
    from chirrup_tpu_torch.engine.serving import ServingModel
    from chirrup_tpu_torch.models.config import RWKV7Config, RuntimeConfig
    from chirrup_tpu_torch.models.loader import params_from_numpy
    from chirrup_tpu_torch.utils.tokenizer import WorldTokenizer

    chats = [{"model": "rwkv-latest:no-thinking",
              "messages": [{"role": "user", "content": "hello world"}],
              "max_tokens": 6, "temperature": 0.0, "ignore_eos": True,
              "use_state_cache": False, "cache_prefill": False},
             {"model": "rwkv-latest:thinking",
              "messages": [{"role": "system", "content": "the"},
                           {"role": "user", "content": "User hello"}],
              "max_tokens": 5, "temperature": 0.0, "ignore_eos": True,
              "presence_penalty": 1.5, "stream": True,
              "use_state_cache": False, "cache_prefill": False}]

    loop = asyncio.new_event_loop()
    jconfig = JServerConfig(vocab_path=vocab_path, vocab_size=VOCAB_SIZE, worker_num=1,
                            batch_size=2, state_cache_size=0, quantization="none")
    mc = synthetic_model_config(vocab_path)
    client = TestClient(TestServer(j_create_app(jconfig, model_factory=j_factory(
        mc, batch_size=2))), loop=loop)
    loop.run_until_complete(asyncio.wait_for(client.start_server(), 240))

    async def jax_post(body, raw=False):
        resp = await client.post("/v1/chat/completions",
                                 **({"data": body, "headers": {
                                     "Content-Type": "application/json"}}
                                    if raw else {"json": body}))
        return resp.status, (await resp.read())

    try:
        jax_out = [loop.run_until_complete(asyncio.wait_for(jax_post(b), 120))
                   for b in chats]
        jax_errors = [loop.run_until_complete(asyncio.wait_for(jax_post(b, raw=True), 60))
                      for b in MALFORMED]
    finally:
        loop.run_until_complete(client.close())
        loop.close()

    def factory():
        dense = jax.tree_util.tree_map(
            np.asarray, j_synthetic_params(JConfig(**SYNTHETIC), seed=0))
        rt = RuntimeConfig(activation_dtype=torch.float32, wkv_state_dtype=torch.float32)
        model = ServingModel(RWKV7Config(**SYNTHETIC), params_from_numpy(dense, device="cpu"),
                             rt, 2, prefill_chunk=8, device="cpu")
        return model, WorldTokenizer(vocab_path)

    port_srv = Running(App(ServerConfig(vocab_path=vocab_path, vocab_size=VOCAB_SIZE,
                                               batch_size=2, state_cache_size=0,
                                               quantization="none", device="cpu"),
                                  model_factory=factory))
    try:
        port_out = [request(port_srv.port, "POST", "/v1/chat/completions", b)[::2]
                    for b in chats]
    finally:
        port_srv.close()

    def content(body: bytes, stream: bool):
        if not stream:
            msg = json.loads(body)["choices"][0]["message"]
            return msg["content"], msg["reasoning_content"]
        frames = [json.loads(l[6:]) for l in body.decode().split("\n")
                  if l.startswith("data: ") and l != "data: [DONE]"]
        deltas = [f["choices"][0]["delta"] for f in frames]
        return ("".join(d.get("content", "") for d in deltas),
                "".join(d.get("reasoning_content", "") for d in deltas),
                frames[-1]["usage"]["completion_tokens"])

    for chat, (js, jb), (ps, pb) in zip(chats, jax_out, port_out):
        assert js == ps == 200
        assert content(pb, chat.get("stream", False)) == content(jb, chat.get("stream", False))
        assert json.loads(pb.decode().split("data: ")[-2] if chat.get("stream") else pb)[
            "usage"] == json.loads(jb.decode().split("data: ")[-2] if chat.get("stream")
                                   else jb)["usage"]
    for b, (js, jb) in zip(MALFORMED, jax_errors):
        ps, _, pb = request(server.port, "POST", "/v1/chat/completions", b, raw=True)
        je, pe = json.loads(jb)["error"], json.loads(pb)["error"]
        assert (ps, pe["type"], pe.get("code")) == (js, je["type"], je.get("code")), b


# --------------------------------------------------- the prefix cache's server half


def _state(seed):
    g = torch.Generator().manual_seed(seed)
    return RequestState(shift=torch.randn(2, 2, 8, generator=g),
                        wkv=torch.randn(2, 4, 8, generator=g), elapsed=seed)


def test_cache_event_prepends_resumed_prefix():
    """A resumed request prefills only the suffix: its snapshot is cached
    under resumed prefix + prefilled tokens, never under the suffix alone."""
    cache = PrefixStateCache(max_size=4)
    st = _state(7)
    asyncio.run(_cache_event(cache, {"state": st, "prefilled_tokens": (5, 6)}, (1, 2, 3)))
    _, got, n = cache.check([1, 2, 3, 5, 6, 9])
    assert got is st and n == 5
    assert cache.check([5, 6, 9])[1] is None


def test_skipped_snapshot_wakes_followers():
    """A leader whose snapshot was skipped (no pool row) wakes its dedup
    followers at once; they find nothing cached and prefill themselves."""
    async def go():
        cache = PrefixStateCache(max_size=4)
        tokens = [1, 2, 3, 4, 5]
        _, _, _, claim = await cache.check_and_wait_prefill(tokens, 1, return_claim=True)
        assert claim is not None
        follower = asyncio.create_task(cache.check_and_wait_prefill(tokens, 1))
        await asyncio.sleep(0.05)
        assert not follower.done()
        await _cache_event(cache, {"state": None, "prefilled_tokens": (1, 2, 3, 4)})
        remaining, state, cached = await asyncio.wait_for(follower, 5)
        assert state is None and list(remaining) == tokens and cached == 0
        assert len(cache) == 0

    asyncio.run(go())


def test_dedup_leader_takes_the_only_snapshot(server, recorded):
    """N identical prompts at once: one leader snapshots; the followers wait
    for it and resume from the cache, with the leader's greedy text."""
    n = 4
    body = {"model": "rwkv-latest:no-thinking", "max_tokens": 3, "temperature": 0.0,
            "messages": [{"role": "user", "content": "dedup world the same prompt"}]}
    stats0 = server.app.state_cache.stats()
    with concurrent.futures.ThreadPoolExecutor(n) as pool:
        outs = list(pool.map(lambda _: request(server.port, "POST", "/v1/chat/completions",
                                               body), range(n)))
    assert all(s == 200 for s, _, _ in outs)
    texts = {json.loads(b)["choices"][0]["message"]["content"] for _, _, b in outs}
    assert len(texts) == 1
    assert len(recorded) == n
    assert sum(kw["cache_prefill"] for _, kw in recorded) == 1
    assert sum(kw["state"] is not None for _, kw in recorded) == n - 1
    stats = server.app.state_cache.stats()
    assert stats["entries"] == stats0["entries"] + 1
    assert stats["hits"] - stats0["hits"] == n - 1


@pytest.mark.parametrize("stream", [True, False])
def test_client_hangup_aborts_its_completion(server, recorded, stream):
    body = json.dumps({"messages": [{"role": "user", "content": "hang up on me"}],
                       "max_tokens": 100000, "ignore_eos": True, "stream": stream,
                       "use_state_cache": False, "cache_prefill": False}).encode()
    sock = socket.create_connection(("127.0.0.1", server.port), timeout=60)
    sock.sendall(b"POST /v1/chat/completions HTTP/1.1\r\nHost: x\r\n"
                 b"Content-Type: application/json\r\nContent-Length: %d\r\n\r\n%s"
                 % (len(body), body))
    head = b""
    while b"\r\n\r\n" not in head:
        head += sock.recv(4096)
    if stream:
        while b"data: " not in head:
            head += sock.recv(4096)
    deadline = time.time() + 60
    while not recorded or not recorded[0][0].task.generated_tokens:
        assert time.time() < deadline
        time.sleep(0.05)
    sock.close()
    task = recorded[0][0].task
    while task.request_status != RequestStatus.FINISHED_ABORTED:
        assert time.time() < deadline, task.request_status
        time.sleep(0.05)
    assert len(task.generated_tokens) < 100000
    assert request(server.port, "GET", "/health")[0] == 200


# ------------------------------------------------------- configuration and entry point


def test_config_layering_and_refusals(monkeypatch):
    monkeypatch.setenv("BATCH_SIZE", "12")
    cfg = parse_config(["--profile", "h100-7b2", "--state-cache-size", "3"])
    assert cfg.batch_size == 12  # env over profile
    assert cfg.state_cache_size == 3  # CLI over profile
    assert cfg.decode_block_size == PROFILES["h100-7b2"]["decode_block_size"]
    assert parse_config([]).batch_size == 12
    for argv in (["--tensor-parallel", "2"], ["--lockstep", "1"], ["--profile", "v5e-7b2"]):
        with pytest.raises(SystemExit):
            parse_config(argv)


def test_main_without_a_device_raises(vocab_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the server would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app_mod.main(["--vocab-path", vocab_path])


def _spawn(args):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.Popen([sys.executable, "-m", "chirrup_tpu_torch.server",
                             "--host", "127.0.0.1", "--port", "0", *args], cwd=REPO,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def test_entry_point_serves_and_stops_on_sigint(vocab_path):
    """python -m chirrup_tpu_torch.server --device cpu --synthetic-model L,C
    binds, reports its port, serves a completion, and exits 0 on SIGINT."""
    proc = _spawn(["--device", "cpu", "--synthetic-model", "2,128", "--vocab-path",
                   vocab_path, "--vocab-size", str(VOCAB_SIZE), "--quantization", "none",
                   "--batch-size", "2", "--state-cache-size", "4"])
    try:
        port, lines = None, []
        deadline = time.time() + 120
        while port is None:
            assert time.time() < deadline and proc.poll() is None, lines
            line = proc.stderr.readline()
            lines.append(line)
            if "listening on http://" in line:
                port = int(line.rsplit(":", 1)[1].split(";")[0])
        while request(port, "GET", "/health")[0] != 200:
            assert time.time() < deadline and proc.poll() is None
            time.sleep(0.2)
        status, _, body = request(port, "POST", "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "hello"}], "max_tokens": 3,
            "ignore_eos": True})
        assert status == 200 and json.loads(body)["usage"]["completion_tokens"] == 3
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        proc.stderr.close()


def test_entry_point_exits_nonzero_when_loading_fails(vocab_path, tmp_path):
    proc = _spawn(["--device", "cpu", "--model-path", str(tmp_path / "missing.pth"),
                   "--vocab-path", vocab_path, "--load-timeout", "60"])
    try:
        _, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode != 0
    assert "model load failed" in err


def test_server_imports_no_foreign_package():
    """chirrup_tpu_torch.server.app (and every module it imports) loads with
    jax, chirrup_tpu, aiohttp, pydantic and ml_dtypes blocked."""
    code = (
        "import sys\n"
        "blocked = ('jax', 'chirrup_tpu', 'aiohttp', 'pydantic', 'ml_dtypes')\n"
        "for m in blocked:\n"
        "    sys.modules[m] = None\n"
        "import chirrup_tpu_torch.server.app, chirrup_tpu_torch.server.__main__\n"
        "import chirrup_tpu_torch.models.checkpoint, chirrup_tpu_torch.models.loader\n"
        "bad = [m for m, v in sys.modules.items() if v is not None\n"
        "       and m.split('.')[0] in blocked]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
