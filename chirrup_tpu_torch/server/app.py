"""OpenAI-compatible HTTP server over the port's AsyncEngineCore.

The JAX server's surface (chirrup_tpu/server/app.py) on the standard library
(server/http.py in place of aiohttp, server/api_models.py in place of
pydantic): /health (503 until the model is loaded), /metrics, /v1/models,
/v1/chat/completions (server-sent events with keep-alive comments, think-tag
routing into delta.reasoning_content, the prefix state cache with prefill
dedup), /v1/batch/translate, /v1/batch/rollout, OpenAI-style error JSON.

    python -m chirrup_tpu_torch.server --model-path <.pth or native dir> --vocab-path ...

binds first, answers /health with 503 while the engine loads (every serving
program warmed up, on the card captured as CUDA graphs), and exits non-zero
when loading fails; SIGINT or SIGTERM stops it with exit code 0.
"""

from __future__ import annotations

import asyncio
import logging
import signal
import sys
import time
import traceback
import uuid
from collections import deque
from typing import Dict, List, Optional

from chirrup_tpu_torch import resolve_device
from chirrup_tpu_torch.engine.engine import AsyncEngineCore
from chirrup_tpu_torch.engine.interface import AsyncEngineCompletion
from chirrup_tpu_torch.engine.state_cache import PrefixStateCache
from chirrup_tpu_torch.engine.structures import (
    DEFAULT_STOP_TOKENS, ModelLoadConfig, PoolHandle)
from chirrup_tpu_torch.ops import _kernels
from chirrup_tpu_torch.server.api_models import (
    ChatCompletionRequest, ChatCompletionResponse, ChatCompletionResponseChoice,
    ChatCompletionResponseUsage, ChatCompletionStreamChoice, ChatCompletionStreamResponse,
    ChatMessage, ModelInfo, ModelsResponse, RolloutRequest, RolloutStreamChoice,
    RolloutStreamResponse, TranslateRequest, TranslateResponse, TranslationResult)
from chirrup_tpu_torch.server.config import ServerConfig, parse_config
from chirrup_tpu_torch.server.http import (
    KEEPALIVE_SECONDS, SSE_KEEPALIVE, HTTPError, Request, Server, StreamResponse, dumps,
    error_json, json_response)
from chirrup_tpu_torch.utils.prompt_formatters import (
    format_no_thinking, format_quick_thinking, format_with_thinking)
from chirrup_tpu_torch.utils.streaming_parser import (
    StreamingStringParser, TRIE_THINK_NO_TRIGGER)

log = logging.getLogger(__name__)

_LANG_NAMES = {
    "zh-CN": "Chinese", "zh-TW": "Chinese", "en": "English", "ja": "Japanese",
    "fr": "French", "de": "German", "es": "Spanish", "ru": "Russian",
}


def _select_template(model_name: str):
    """model suffix -> (formatter, cache_prefill_padding)."""
    parts = model_name.split(":")
    if "thinking" in parts:
        return format_with_thinking, 3
    if "no-thinking" in parts:
        return format_no_thinking, 0
    return format_quick_thinking, 7


def _model_config_from_server_config(config: ServerConfig) -> ModelLoadConfig:
    synthetic = None
    if config.synthetic_model:
        L, C = (int(x) for x in config.synthetic_model.split(","))
        synthetic = dict(n_layer=L, n_embd=C, vocab_size=config.vocab_size)
    return ModelLoadConfig(
        model_path=config.model_path,
        vocab_path=config.vocab_path,
        vocab_size=config.vocab_size,
        head_size=config.head_size,
        quantization=None if config.quantization in ("none", "") else config.quantization,
        wkv_state_dtype=config.wkv_state_dtype,
        activation_dtype=config.activation_dtype,
        prefill_chunk=config.prefill_chunk,
        synthetic_config=synthetic,
    )


class App:
    """The server's state and routes (the JAX package's create_app). start()
    binds it; load() builds and loads the engine, unless one was given (a
    loaded engine, or a model factory, for tests)."""

    def __init__(self, config: ServerConfig, *, engine: Optional[AsyncEngineCore] = None,
                 state_cache: Optional[PrefixStateCache] = None, model_factory=None):
        self.config = config
        self.engine = engine
        self.model_factory = model_factory
        self.state_cache = state_cache if state_cache is not None else (
            PrefixStateCache(config.state_cache_size)
            if config.state_cache_size > 0 else None)
        created = int(time.time())
        self.model_list = [
            ModelInfo(id=name, created=created, owned_by="chirrup_tpu")
            for name in ("rwkv-latest", "rwkv-latest:thinking", "rwkv-latest:no-thinking")]
        self.worker_perf: Dict[str, dict] = {}
        # (queue_wait, compute_wait, dedup_wait) of the last requests
        self.ttft_samples: deque = deque(maxlen=2048)
        self.server = Server(self, {
            ("GET", "/health"): handle_health,
            ("GET", "/metrics"): handle_metrics,
            ("GET", "/v1/models"): handle_models,
            ("POST", "/v1/chat/completions"): handle_chat_completions,
            ("POST", "/v1/batch/translate"): handle_translate,
            ("POST", "/v1/batch/rollout"): handle_rollout,
        })
        self._perf_task: Optional[asyncio.Task] = None

    async def start(self, host: Optional[str] = None, port: Optional[int] = None) -> int:
        """Bind and serve (port 0: a free one); returns the port."""
        return await self.server.start(host or self.config.host,
                                       self.config.port if port is None else port)

    async def load(self) -> None:
        """Build the engine (unless one was given) and start collecting its
        workers' telemetry; raises when the model fails to load."""
        if self.engine is None:
            config = self.config
            engine = AsyncEngineCore()
            try:
                await engine.init(worker_num=config.worker_num,
                                  model_config=_model_config_from_server_config(config),
                                  batch_size=config.batch_size,
                                  model_factory=self.model_factory,
                                  device=config.device or None,
                                  state_pool_size=config.state_cache_size,
                                  decode_block_size=config.decode_block_size or None,
                                  load_timeout=config.load_timeout,
                                  warmup_programs=True)
            except BaseException:
                engine.shutdown()
                raise
            self.engine = engine
            log.info("tokenizer: %s trie", engine.tokenizer.trie)
        # /metrics counts the kernel launches of serving, not of the warm-up
        _kernels.reset_launches()
        self._perf_task = asyncio.create_task(self._collect_perf())

    async def _collect_perf(self) -> None:
        async for worker_id, payload in self.engine.iter_worker_performance():
            self.worker_perf[worker_id] = payload

    async def close(self) -> None:
        await self.server.close()
        if self._perf_task is not None:
            self._perf_task.cancel()
        if self.engine is not None:
            self.engine.shutdown()
            self.engine.join(timeout=30)


# ------------------------------------------------------------------ handlers


async def handle_health(request: Request):
    """503 until the engine is live, so a probe gating on the status never
    routes traffic to a server whose model is still loading."""
    loaded = request.app.engine is not None
    return json_response({
        "status": "healthy" if loaded else "loading",
        "timestamp": int(time.time()),
        "model_loaded": loaded,
    }, status=200 if loaded else 503)


async def handle_models(request: Request):
    return json_response(ModelsResponse(data=request.app.model_list).to_json())


async def handle_metrics(request: Request):
    """Latest per-worker serving telemetry, the state cache's counters, the
    TTFT breakdown, the tokenizer's trie ("c" or "python") and each CUDA
    kernel's launches since the model was loaded."""
    app = request.app
    cache = app.state_cache
    return json_response({
        "workers": dict(app.worker_perf),
        "state_cache": None if cache is None else cache.stats(),
        "ttft_breakdown": _ttft_breakdown(app),
        "tokenizer": None if app.engine is None else app.engine.tokenizer.trie,
        "kernel_launches": dict(_kernels.LAUNCHES),
        "timestamp": time.time(),
    })


def _ttft_breakdown(app: App):
    """Percentiles of the TTFT components over the last completed requests:
    queue_wait = enqueue -> admit, compute_wait = admit -> first token
    (prefill + the first decode block), dedup_wait = the wait of a dedup
    follower for the leader's snapshot, before its request is enqueued."""
    samples = app.ttft_samples
    if not samples:
        return None

    def pct(xs, p):
        xs = sorted(xs)
        return round(xs[min(int(len(xs) * p), len(xs) - 1)], 3)

    qw = [s[0] for s in samples]
    cw = [s[1] for s in samples]
    dw = [s[2] for s in samples]
    return {
        "n": len(samples),
        "queue_wait_p50_s": pct(qw, 0.5), "queue_wait_p99_s": pct(qw, 0.99),
        "compute_wait_p50_s": pct(cw, 0.5), "compute_wait_p99_s": pct(cw, 0.99),
        "dedup_wait_p50_s": pct(dw, 0.5), "dedup_wait_p99_s": pct(dw, 0.99),
    }


def _record_ttft(app: App, task) -> None:
    t = task.timing
    if "enqueue" in t and "admit" in t and "first_token" in t:
        app.ttft_samples.append((t["admit"] - t["enqueue"], t["first_token"] - t["admit"],
                                 t.get("cache_wait", 0.0)))


def _finish_reason(task) -> str:
    return str(task.request_status.get_finished_reason(task.request_status) or "stop")


def _engine(request: Request) -> AsyncEngineCore:
    if request.app.engine is None:
        raise HTTPError(503, "model not loaded")
    return request.app.engine


async def handle_chat_completions(request: Request):
    app = request.app
    engine = _engine(request)
    state_cache = app.state_cache
    req = ChatCompletionRequest.from_json(request.json())

    formatter, cache_prefill_padding = _select_template(req.model)
    prompt = formatter([m.to_json() for m in req.messages])
    prefill_tokens = ([0] if req.pad_zero else []) + engine.tokenizer.encode(prompt)

    stop_tokens: List[int] = []
    if req.stop:
        for s in [req.stop] if isinstance(req.stop, str) else req.stop:
            stop_tokens.extend(engine.tokenizer.encode(s))

    will_cache = (app.config.state_cache_size > 0 and req.cache_prefill
                  and state_cache is not None)
    claim = None  # the prefill-leader claim (node, condition); always released
    cache_wait = 0.0
    if req.use_state_cache and state_cache is not None:
        t_cw = time.time()
        real_prefill_tokens, state, _cached, claim = await state_cache.check_and_wait_prefill(
            prefill_tokens, cache_prefill_padding, return_claim=True, can_lead=will_cache)
        # a dedup follower waits here for the leader's snapshot, before its
        # task exists: record the wait for the TTFT breakdown
        cache_wait = time.time() - t_cw
        # a pool handle: hold a reference for this resume, so eviction cannot
        # recycle the row under the request (the worker releases it after the
        # load); a handle revoked since the lookup means a full prefill
        if isinstance(state, PoolHandle) and not state.try_acquire():
            real_prefill_tokens, state = prefill_tokens, None
    else:
        real_prefill_tokens, state = prefill_tokens, None

    # everything after the claim sits in the try, completion construction
    # included (it raises once the engine is shut down): a leaked claim would
    # leave every later identical prompt waiting on a condition nobody wakes
    try:
        completion = engine.completion(
            prompt_str=prompt,
            prefill_tokens=list(real_prefill_tokens),
            state=state,
            temperature=req.temperature,
            top_p=req.top_p,
            max_tokens=req.max_tokens,
            presence_penalty=req.presence_penalty,
            frequency_penalty=req.frequency_penalty,
            penalty_decay=req.penalty_decay,
            stop_tokens=(set() if req.ignore_eos
                         else set(DEFAULT_STOP_TOKENS) | set(stop_tokens)),
            # snapshot only as the prefill leader of this prefix (or when the
            # client skipped the lookup): re-snapshotting a boundary that is
            # already cached churns the fixed pool for no new state
            cache_prefill=will_cache and (claim is not None or not req.use_state_cache),
            cache_prefill_padding=cache_prefill_padding,
        )
        completion.task.timing["cache_wait"] = cache_wait
        # a resumed request prefills only the suffix and its snapshot event
        # carries suffix-relative tokens: the cache key needs the resumed
        # prefix in front (a suffix-only key would let a prompt that really
        # starts with the suffix resume a state that holds the prefix)
        resumed_prefix = tuple(prefill_tokens[:len(prefill_tokens) - len(real_prefill_tokens)])
        if req.stream:
            return await _stream_chat(request, completion, req, prefill_tokens,
                                      resumed_prefix)
        return await _non_stream_chat(request, completion, req, prefill_tokens,
                                      resumed_prefix)
    finally:
        if claim is not None:
            # a no-op when the cache event released it, or a newer leader
            # holds the node
            await state_cache.release_claim(claim)


async def _cache_event(state_cache: Optional[PrefixStateCache], payload: Dict,
                       prefix: tuple = ()) -> None:
    """Insert a worker snapshot into the prefix cache under prefix +
    prefilled tokens (`prefix`: the resumed-from-cache prefix the worker
    never saw)."""
    if state_cache is None:
        return
    key = prefix + tuple(payload["prefilled_tokens"])
    if payload.get("state") is None:
        # the snapshot was skipped (no pool row): nothing to cache, but wake
        # the dedup followers now, so they prefill at once instead of waiting
        # out the leader's whole generation
        node = state_cache._find(key)
        if node is not None:
            await state_cache.awake_hang_up_prefills(node)
        return
    node = state_cache.cache(key, payload["state"], return_trie_node=True)
    await state_cache.awake_hang_up_prefills(node)


def _sse_response() -> StreamResponse:
    return StreamResponse(headers={
        "Content-Type": "text/event-stream",
        "Cache-Control": "no-cache",
        "Connection": "keep-alive",
        "X-Accel-Buffering": "no",
    })


async def _stream_chat(request: Request, completion: AsyncEngineCompletion,
                       req: ChatCompletionRequest, prefill_tokens: List[int],
                       cache_prefix: tuple = ()) -> StreamResponse:
    app = request.app
    completion_id = f"chatcmpl-{uuid.uuid4().hex}"
    created = int(time.time())
    resp = _sse_response()
    await resp.prepare(request)

    parser = StreamingStringParser(tries=TRIE_THINK_NO_TRIGGER)
    parser.parse(completion.task.prompt_str.split("\n\n")[-1])
    stream_q: asyncio.Queue = asyncio.Queue()

    # the content frame's JSON is built once; a token only JSON-escapes its
    # text into it
    probe = ChatCompletionStreamResponse(
        id=completion_id, created=created, model=req.model,
        choices=[ChatCompletionStreamChoice(index=0, delta={"content": "\x00"})])
    c_prefix, c_suffix = dumps(probe.to_json()).split('"\\u0000"')

    def content_frame(text: str) -> str:
        return f"data: {c_prefix}{dumps(text)}{c_suffix}\n\n"

    async def producer():
        try:
            async for event in completion:
                if event[0] == "token":
                    # the whole coalesced block in one pass: one queue item
                    # and one socket write for all of it
                    frames: List[str] = []
                    for ev in [event] + completion.drain_buffered():
                        for text, st in parser.parse(ev[2]):
                            if st == "content":
                                frames.append(content_frame(text))
                            elif st == "reasoning_content":
                                chunk = ChatCompletionStreamResponse(
                                    id=completion_id, created=created, model=req.model,
                                    choices=[ChatCompletionStreamChoice(
                                        index=0, delta={"content": "",
                                                        "reasoning_content": text})])
                                frames.append(f"data: {dumps(chunk.to_json())}\n\n")
                    if frames:
                        stream_q.put_nowait("".join(frames))
                elif event[0] == "cache_prefill":
                    await _cache_event(app.state_cache, event[1], cache_prefix)
        except Exception as exc:  # noqa: BLE001 — reported in the stream
            traceback.print_exc()
            stream_q.put_nowait(f"data: {dumps(error_json(str(exc), 'internal_error'))}\n\n")
        _record_ttft(app, completion.task)
        # the terminal frame: finish_reason and the server's token counts
        n_gen = len(completion.task.generated_tokens)
        final = ChatCompletionStreamResponse(
            id=completion_id, created=created, model=req.model,
            choices=[ChatCompletionStreamChoice(
                index=0, delta={}, finish_reason=_finish_reason(completion.task))],
            usage=ChatCompletionResponseUsage(
                prompt_tokens=len(prefill_tokens), completion_tokens=n_gen,
                total_tokens=len(prefill_tokens) + n_gen))
        stream_q.put_nowait(f"data: {dumps(final.to_json())}\n\n")
        stream_q.put_nowait("data: [DONE]\n\n")
        stream_q.put_nowait(None)

    task = asyncio.create_task(producer())
    try:
        while True:
            try:
                chunk = await asyncio.wait_for(stream_q.get(), KEEPALIVE_SECONDS)
            except asyncio.TimeoutError:
                await resp.write(SSE_KEEPALIVE)
                continue
            if chunk is None:
                break
            await resp.write(chunk.encode())
        await resp.write_eof()
    finally:
        # a client that hung up lands here too (CancelledError or
        # ConnectionResetError): the completion is aborted either way
        task.cancel()
        completion.abort()
    return resp


async def _write_until(resp: StreamResponse, aw, filler: bytes):
    """Await `aw`, writing `filler` every KEEPALIVE_SECONDS meanwhile, so
    proxies keep the connection open during a long generation."""
    fut = asyncio.ensure_future(aw)
    try:
        while True:
            try:
                return await asyncio.wait_for(asyncio.shield(fut), KEEPALIVE_SECONDS)
            except asyncio.TimeoutError:
                await resp.write(filler)
    finally:
        fut.cancel()


async def _non_stream_chat(request: Request, completion: AsyncEngineCompletion,
                           req: ChatCompletionRequest, prefill_tokens: List[int],
                           cache_prefix: tuple = ()) -> StreamResponse:
    """The completion as one JSON body, sent chunked so proxies keep the
    connection alive during generation."""
    app = request.app
    completion_id = f"chatcmpl-{uuid.uuid4().hex}"
    created = int(time.time())
    resp = StreamResponse(headers={"Content-Type": "application/json",
                                   "Cache-Control": "no-cache",
                                   "X-Accel-Buffering": "no"})
    await resp.prepare(request)

    parser = StreamingStringParser(tries=TRIE_THINK_NO_TRIGGER)
    parser.parse(completion.task.prompt_str.split("\n\n")[-1])

    async def collect():
        content, reasoning = [], []
        async for event in completion:
            if event[0] == "token":
                for text, st in parser.parse(event[2]):
                    if st == "content":
                        content.append(text)
                    elif st == "reasoning_content":
                        reasoning.append(text)
            elif event[0] == "cache_prefill":
                await _cache_event(app.state_cache, event[1], cache_prefix)
        return "".join(content), "".join(reasoning)

    try:
        try:
            content, reasoning = await collect()
            _record_ttft(app, completion.task)
            n_gen = len(completion.task.generated_tokens)
            body = ChatCompletionResponse(
                id=completion_id, created=created, model=req.model,
                choices=[ChatCompletionResponseChoice(
                    index=0,
                    message=ChatMessage(role="assistant", content=content,
                                        reasoning_content=reasoning),
                    finish_reason=_finish_reason(completion.task))],
                usage=ChatCompletionResponseUsage(
                    prompt_tokens=len(prefill_tokens), completion_tokens=n_gen,
                    total_tokens=len(prefill_tokens) + n_gen))
            await resp.write(dumps(body.to_json()).encode())
        except ConnectionError:
            raise
        except Exception as exc:  # noqa: BLE001 — reported in the body
            traceback.print_exc()
            await resp.write(dumps(error_json(str(exc), "internal_error")).encode())
        await resp.write_eof()
    finally:
        completion.abort()
    return resp


async def handle_translate(request: Request):
    """Batch translation: one completion a text."""
    engine = _engine(request)
    req = TranslateRequest.from_json(request.json())
    completion_id = f"chatcmpl-{uuid.uuid4().hex}"
    created = int(time.time())
    src = _LANG_NAMES.get(req.source_lang, req.source_lang)
    tgt = _LANG_NAMES.get(req.target_lang, req.target_lang)
    completions = [engine.completion(f"{src}: {text}\n\n{tgt}:", max_tokens=2048,
                                     temperature=0.5)
                   for text in req.text_list]
    resp = StreamResponse(headers={"Content-Type": "application/json",
                                   "Cache-Control": "no-cache"})
    await resp.prepare(request)
    try:
        try:
            results = await _write_until(
                resp, asyncio.gather(*[c.get_full_completion() for c in completions]),
                b"\n\n")
            body = TranslateResponse(
                translations=[TranslationResult(text=t, detected_source_lang=req.source_lang)
                              for t in results],
                id=completion_id, created=created)
            await resp.write(dumps(body.to_json()).encode())
        except ConnectionError:
            raise
        except Exception as exc:  # noqa: BLE001 — reported in the body
            await resp.write(dumps(error_json(str(exc), "internal_error")).encode())
        await resp.write_eof()
    finally:
        for c in completions:
            c.abort()
    return resp


async def handle_rollout(request: Request):
    """Batch raw-prompt rollout, streamed (each frame tagged with its
    prompt's index) or as one body."""
    engine = _engine(request)
    req = RolloutRequest.from_json(request.json())
    completion_id = f"chatcmpl-{uuid.uuid4().hex}"
    created = int(time.time())
    completions = [
        engine.completion(
            content, state=None, temperature=req.temperature, top_p=req.top_p,
            max_tokens=req.max_tokens, presence_penalty=req.presence_penalty,
            frequency_penalty=req.frequency_penalty, penalty_decay=req.penalty_decay,
            stop_tokens=req.stop_tokens)
        for content in req.contents
    ]
    resp = StreamResponse(headers={
        "Content-Type": "text/event-stream" if req.stream else "application/json",
        "Cache-Control": "no-cache", "X-Accel-Buffering": "no"})
    await resp.prepare(request)
    tasks: List[asyncio.Task] = []
    try:
        try:
            if req.stream:
                stream_q: asyncio.Queue = asyncio.Queue()

                async def pump(index: int, completion: AsyncEngineCompletion):
                    try:
                        async for event in completion:
                            if event[0] == "token":
                                stream_q.put_nowait((index, event[2]))
                    finally:
                        stream_q.put_nowait(None)

                tasks = [asyncio.create_task(pump(i, c)) for i, c in enumerate(completions)]
                remaining = len(completions)
                while remaining > 0:
                    try:
                        item = await asyncio.wait_for(stream_q.get(), 5.0)
                    except asyncio.TimeoutError:
                        await resp.write(SSE_KEEPALIVE)
                        continue
                    if item is None:
                        remaining -= 1
                        continue
                    chunk = RolloutStreamResponse(
                        id=completion_id, created=created, model=req.model,
                        choices=[RolloutStreamChoice(index=item[0],
                                                     delta={"content": item[1]})])
                    await resp.write(f"data: {dumps(chunk.to_json())}\n\n".encode())
            else:
                results = await _write_until(
                    resp, asyncio.gather(*[c.get_full_completion() for c in completions]),
                    b"\n\n")
                body = RolloutStreamResponse(
                    id=completion_id, created=created, model=req.model,
                    rollouts=[RolloutStreamChoice(index=i, delta={"content": r})
                              for i, r in enumerate(results)])
                await resp.write(dumps(body.to_json()).encode())
        except ConnectionError:
            raise
        except Exception as exc:  # noqa: BLE001 — reported in the body
            await resp.write(
                f"data: {dumps(error_json(str(exc), 'internal_error'))}\n\n".encode())
        await resp.write_eof()
    finally:
        for t in tasks:
            t.cancel()
        for c in completions:
            c.abort()
    return resp


# ---------------------------------------------------------------- entry point


async def serve(config: ServerConfig) -> int:
    """Bind, load, serve until SIGINT or SIGTERM; the exit code."""
    app = App(config)
    port = await app.start()
    log.info("listening on http://%s:%d; loading the model", config.host, port)
    loop = asyncio.get_running_loop()
    stop = asyncio.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    stopping = asyncio.create_task(stop.wait())
    loading = asyncio.create_task(app.load())
    await asyncio.wait({loading, stopping}, return_when=asyncio.FIRST_COMPLETED)
    code = 0
    if not loading.done():
        loading.cancel()
        await asyncio.wait({loading})
    elif loading.exception() is not None:
        traceback.print_exception(loading.exception())
        log.error("model load failed; exiting")
        code = 1
    else:
        log.info("model loaded; serving")
        await stopping
    stopping.cancel()
    await app.close()
    return code


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    config = parse_config(argv)
    resolve_device(config.device or None)  # no device given and no CUDA: raises
    return asyncio.run(serve(config))


if __name__ == "__main__":
    sys.exit(main())
