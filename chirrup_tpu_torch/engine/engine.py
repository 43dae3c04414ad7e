"""AsyncEngineCore — asyncio façade over the worker threads.

A shared task queue gives work-stealing request-level parallelism across
workers; a ThreadSafeAsyncQueue bridges each worker thread back into the event
loop; init waits for every worker's worker_loaded handshake. A worker drives
one device. With `state_pool_size`, a single worker keeps prefix snapshots in
a device state pool (PoolHandle events); otherwise they go to the host.
"""

from __future__ import annotations

import asyncio
import queue
import threading
import uuid
from typing import Any, Callable, List, Optional, Sequence, Union

import torch

from chirrup_tpu_torch import resolve_device
from chirrup_tpu_torch.engine.interface import AsyncEngineCompletion
from chirrup_tpu_torch.engine.structures import (
    DEFAULT_SAMPLING_CONFIG, DEFAULT_STOP_TOKENS, ModelLoadConfig, PoolHandle, RequestState,
    Task)
from chirrup_tpu_torch.engine.worker import Worker, start_worker_thread
from chirrup_tpu_torch.utils.tokenizer import WorldTokenizer

# the dtypes the kernels take
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class ThreadSafeAsyncQueue:
    """Worker threads put_nowait; the asyncio side reads .queue."""

    def __init__(self, event_loop: asyncio.AbstractEventLoop,
                 async_queue: Optional[asyncio.Queue] = None):
        self.event_loop = event_loop
        self.queue: asyncio.Queue = async_queue or asyncio.Queue()

    def put_nowait(self, item: Any) -> None:
        try:
            self.event_loop.call_soon_threadsafe(self._put, item)
        except RuntimeError:
            pass  # loop closed: the consumer is gone

    def _put(self, item: Any) -> None:
        try:
            self.queue.put_nowait(item)
        except asyncio.QueueFull:
            pass


def build_model_factory(model_config: ModelLoadConfig, batch_size: int, device=None,
                        seed: int = 0) -> Callable:
    """A callable the worker thread invokes to construct its ServingModel and
    tokenizer. The device is resolved here, so building a factory without a
    device where CUDA is absent raises at once. The model is
    model_config.synthetic_config's random one (from `seed`), or the
    checkpoint at model_config.model_path: a native directory
    (models/checkpoint.py; an INT8 one is served as it is stored) or a `.pth`
    (quantized by ServingModel under quantization="int8")."""
    from chirrup_tpu_torch.engine.serving import ServingModel
    from chirrup_tpu_torch.models import checkpoint, loader
    from chirrup_tpu_torch.models.config import RWKV7Config, RuntimeConfig

    device = resolve_device(device)

    def factory():
        runtime = RuntimeConfig(
            activation_dtype=_DTYPES[model_config.activation_dtype],
            wkv_state_dtype=_DTYPES[model_config.wkv_state_dtype],
            quantization=model_config.quantization, mm8_core=model_config.mm8_core)
        path = model_config.model_path
        if model_config.synthetic_config is not None:
            cfg = RWKV7Config(**model_config.synthetic_config)
            if runtime.quantization == "int8":
                make = lambda: loader.synthetic_params_int8(
                    cfg, seed=seed, dtype=runtime.activation_dtype, device=device)
            else:
                make = lambda: loader.synthetic_params(cfg, seed=seed, device=device)
        elif checkpoint.is_native_checkpoint(path):
            cfg = checkpoint.native_config(path)
            make = lambda: checkpoint.load_native(path, device=device)[1]
        else:
            sd = loader.load_state_dict_pth(path)
            cfg = loader.infer_config(sd, vocab_size=model_config.vocab_size)
            make = lambda: loader.params_from_state_dict(sd, cfg, device=device)
        # the model makes the tree itself and holds the only reference
        model = ServingModel(cfg, make, runtime, batch_size,
                             prefill_chunk=model_config.prefill_chunk, device=device,
                             seed=seed)
        return model, WorldTokenizer(model_config.vocab_path)

    return factory


class AsyncEngineCore:
    """Engine façade: init / completion / shutdown / iter_worker_performance."""

    def __init__(self):
        self.task_queue: "queue.Queue[Task]" = queue.Queue()
        self.event_queues: List[queue.Queue] = []
        self.workers: List[Worker] = []
        self.worker_threads: List[threading.Thread] = []
        self.worker_event_queue: Optional[ThreadSafeAsyncQueue] = None
        self.event_loop: Optional[asyncio.AbstractEventLoop] = None
        self.tokenizer: Optional[WorldTokenizer] = None
        self.is_initialized = False
        self.is_shutdown = False
        self._perf_listeners: List[asyncio.Queue] = []
        self._drain_task: Optional[asyncio.Task] = None

    async def init(self, worker_num: int, model_config: ModelLoadConfig,
                   batch_size: int = 32, *, load_timeout: float = 300.0,
                   decode_block_size: Optional[int] = None,
                   model_factory: Optional[Callable] = None, device=None,
                   warmup_programs: bool = False, state_pool_size: int = 0) -> None:
        """Spawn workers and wait for their worker_loaded handshake. Worker k
        runs on `device`, or on CUDA device k mod the device count when none is
        given; model_factory replaces the synthetic-model factory.
        warmup_programs: each worker runs every serving program once (on
        CUDA: captures its graphs) before it reports itself loaded.
        state_pool_size: rows of the device state pool for prefix snapshots,
        plus 4 of headroom for snapshot bursts that race the cache's
        releases; only with one worker (a handle is a row of one worker's
        pool), and otherwise snapshots go to the host."""
        if self.is_initialized:
            raise RuntimeError("Workers already initialized")
        if self.is_shutdown:
            raise RuntimeError("Engine has been shutdown")
        devices = [device]
        if model_factory is None and device is None:
            resolve_device(None)  # raises without CUDA
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        self.event_loop = asyncio.get_running_loop()
        self.worker_event_queue = ThreadSafeAsyncQueue(
            self.event_loop, asyncio.Queue(maxsize=worker_num * 100))
        self.is_initialized = True
        self.tokenizer = WorldTokenizer(model_config.vocab_path)
        pool_rows = 0
        if state_pool_size > 0:
            if worker_num == 1:
                pool_rows = state_pool_size + 4
            else:
                print("state pool disabled: worker_num > 1 (host snapshots in effect)")
        for k in range(worker_num):
            master_q: queue.Queue = queue.Queue()
            self.event_queues.append(master_q)
            factory = model_factory or build_model_factory(
                model_config, batch_size, device=devices[k % len(devices)], seed=k)
            worker = Worker(worker_id=f"worker_{k}", model_factory=factory,
                            task_queue=self.task_queue, master_event_queue=master_q,
                            worker_event_queue=self.worker_event_queue,
                            batch_size=batch_size, decode_block_size=decode_block_size,
                            warmup_programs=warmup_programs, state_pool_size=pool_rows)
            self.workers.append(worker)
            self.worker_threads.append(start_worker_thread(worker))

        loaded: set = set()
        loop = asyncio.get_running_loop()
        deadline = loop.time() + load_timeout
        while len(loaded) < worker_num:
            timeout = deadline - loop.time()
            if timeout <= 0:
                missing = {w.worker_id for w in self.workers} - loaded
                raise RuntimeError(f"workers failed to load in time: {missing}")
            try:
                worker_id, kind, payload = await asyncio.wait_for(
                    self.worker_event_queue.queue.get(), timeout=min(timeout, 1.0))
            except asyncio.TimeoutError:
                continue
            if kind == "worker_loaded":
                if payload.get("status") != "success":
                    raise RuntimeError(f"worker {worker_id} failed to load: {payload}")
                loaded.add(worker_id)
            elif kind == "worker_performance":
                self._dispatch_perf((worker_id, payload))
        self._drain_task = asyncio.create_task(self._drain_events())

    def completion(
        self,
        prompt_str: str,
        prefill_tokens: Optional[List[int]] = None,
        state: Union[RequestState, PoolHandle, None] = None,
        priority: int = 0,
        temperature: float = DEFAULT_SAMPLING_CONFIG["temperature"],
        top_p: float = DEFAULT_SAMPLING_CONFIG["top_p"],
        top_k: int = DEFAULT_SAMPLING_CONFIG["top_k"],
        presence_penalty: float = DEFAULT_SAMPLING_CONFIG["presence_penalty"],
        frequency_penalty: float = DEFAULT_SAMPLING_CONFIG["frequency_penalty"],
        penalty_decay: float = DEFAULT_SAMPLING_CONFIG["penalty_decay"],
        stop_tokens: Optional[Sequence[int]] = DEFAULT_STOP_TOKENS,
        forbidden_tokens: Sequence[int] = (),
        max_tokens: Optional[int] = DEFAULT_SAMPLING_CONFIG["max_tokens"],
        task_id: Optional[str] = None,
        cache_prefill: bool = False,
        cache_prefill_padding: int = 0,
        return_logits: bool = False,
    ) -> AsyncEngineCompletion:
        """Create a streaming completion. `state` resumes from a snapshot (a
        host RequestState, or a PoolHandle whose reference the request
        takes over) with `prefill_tokens` the prompt's suffix after it;
        `cache_prefill` asks for a ("cache_prefill", {"state",
        "prefilled_tokens"}) event where cache_prefill_padding - 1 prompt
        tokens are left."""
        if state is not None and prefill_tokens is None:
            raise ValueError("prefill_tokens cannot be None when state is provided")
        if not self.is_initialized:
            raise RuntimeError("Engine not initialized")
        if self.is_shutdown:
            raise RuntimeError("Engine has been shutdown")
        if not prefill_tokens:
            prefill_tokens = self.tokenizer.encode(prompt_str)
        return AsyncEngineCompletion(
            prompt_str=prompt_str, prefill_tokens=list(prefill_tokens), state=state,
            task_queue=self.task_queue,
            result_channel=ThreadSafeAsyncQueue(self.event_loop),
            task_id=task_id or str(uuid.uuid4()), priority=priority,
            temperature=temperature, top_p=top_p, top_k=top_k,
            presence_penalty=presence_penalty, frequency_penalty=frequency_penalty,
            penalty_decay=penalty_decay, stop_tokens=stop_tokens,
            forbidden_tokens=forbidden_tokens, max_tokens=max_tokens,
            cache_prefill=cache_prefill, cache_prefill_padding=cache_prefill_padding,
            return_logits=return_logits)

    def shutdown(self) -> None:
        """Broadcast shutdown to all workers."""
        if self.is_shutdown:
            return
        self.is_shutdown = True
        if self._drain_task is not None:
            self._drain_task.cancel()
        for q in self.event_queues:
            q.put_nowait({"type": "shutdown"})

    def join(self, timeout: Optional[float] = 10.0) -> None:
        for t in self.worker_threads:
            t.join(timeout=timeout)

    # ------------------------------------------------------------- telemetry

    def _dispatch_perf(self, item):
        for q in self._perf_listeners:
            try:
                q.put_nowait(item)
            except asyncio.QueueFull:
                pass

    async def iter_worker_performance(self):
        """Async-iterate worker telemetry."""
        listener: asyncio.Queue = asyncio.Queue(maxsize=1000)
        self._perf_listeners.append(listener)
        try:
            while not self.is_shutdown:
                yield await listener.get()
        finally:
            self._perf_listeners.remove(listener)

    async def _drain_events(self):
        while True:
            worker_id, kind, payload = await self.worker_event_queue.queue.get()
            if kind == "worker_performance":
                self._dispatch_perf((worker_id, payload))
