"""AsyncEngineCore — asyncio façade over the worker threads.

A shared task queue gives work-stealing request-level parallelism across
workers; a ThreadSafeAsyncQueue bridges each worker thread back into the event
loop; init waits for every worker's worker_loaded handshake. A worker drives
one device. With `state_pool_size`, a single worker keeps prefix snapshots in
a device state pool (PoolHandle events); otherwise they go to the host.

Tensor parallelism (`tensor_parallel` > 1, parallel/tp.py): each worker is
rank 0 of a tp group of its own, a thread of this process on its group's
first device; the group's other ranks are spawned processes that build
their shards of the same model and follow rank 0's ServingModel calls.
Worker k's group runs on CUDA devices k*tp .. (k+1)*tp - 1. Shutdown
stops every group's followers, and join() joins them within its time
limit; a worker that fails to load stops them all.

Lockstep (`model_config.lockstep`, parallel/hosts.py): one engine per host,
each with one worker over its rows of the global batch, the hosts' world
from torch.distributed's environment (dp hosts; one host without it). The
worker votes with the other hosts once a loop; a shutdown on any host
stops every host's worker after the same loop.
"""

from __future__ import annotations

import asyncio
import functools
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
from chirrup_tpu_torch.parallel import hosts
from chirrup_tpu_torch.parallel import tp as tp_mod
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


def build_serving_model(model_config: ModelLoadConfig, batch_size: int, tp=None, *,
                        device=None, seed: int = 0, graphs: bool = True,
                        sampler_seed: Optional[int] = None):
    """The ServingModel of model_config on `device` (resolve_device: the CUDA
    device unless one is given): model_config.synthetic_config's random model
    (from `seed`), or the checkpoint at model_config.model_path, a native
    directory (models/checkpoint.py; an INT8 one is served as it is stored)
    or a `.pth` (quantized by ServingModel under quantization="int8").

    tp: this rank's TPContext; the model runs on tp.device and holds its
    shard. A synthetic INT8 tree and a native checkpoint are read shard by
    shard (no rank uploads the whole tree); a dense tree served as INT8
    (synthetic, `.pth`, a dense native checkpoint) is quantized whole first,
    as meshless serving does, by ServingModel, where the tree lies: on the
    device for a synthetic one, on the host for a checkpoint. With every
    argument but tp bound, this is the build function of tp.start.
    `seed` makes the synthetic weights and, unless `sampler_seed` is given,
    seeds the sampler."""
    from chirrup_tpu_torch.engine.serving import ServingModel
    from chirrup_tpu_torch.models import checkpoint, loader
    from chirrup_tpu_torch.models.config import RWKV7Config, RuntimeConfig

    device = resolve_device(tp.device if tp is not None else device)
    shard = None if tp is None else (tp.rank, tp.world)
    # where a whole checkpoint tree is read under tp: the host
    whole = device if tp is None else torch.device("cpu")
    runtime = RuntimeConfig(
        activation_dtype=_DTYPES[model_config.activation_dtype],
        wkv_state_dtype=_DTYPES[model_config.wkv_state_dtype],
        quantization=model_config.quantization, mm8_core=model_config.mm8_core)
    int8 = runtime.quantization == "int8"
    path = model_config.model_path
    if model_config.synthetic_config is not None:
        cfg = RWKV7Config(**model_config.synthetic_config)
        if int8:
            make = lambda: loader.synthetic_params_int8(
                cfg, seed=seed, dtype=runtime.activation_dtype, device=device, shard=shard)
        else:
            make = lambda: loader.synthetic_params(cfg, seed=seed, device=device)
    elif checkpoint.is_native_checkpoint(path):
        cfg = checkpoint.native_config(path)
        if shard is not None and int8 and not checkpoint.is_quantized(path):
            make = lambda: checkpoint.load_native(path, device=whole)[1]
        else:
            make = lambda: checkpoint.load_native(path, device=device, shard=shard)[1]
    else:
        sd = loader.load_state_dict_pth(path)
        cfg = loader.infer_config(sd, vocab_size=model_config.vocab_size)
        make = lambda: loader.params_from_state_dict(sd, cfg, device=whole)
    # the model makes the tree itself and holds the only reference
    return ServingModel(cfg, make, runtime, batch_size, prefill_chunk=model_config.prefill_chunk,
                        device=device, seed=seed if sampler_seed is None else sampler_seed,
                        graphs=graphs, tp=tp)


def build_model_factory(model_config: ModelLoadConfig, batch_size: int, device=None,
                        seed: int = 0, tp=None, sampler_seed: Optional[int] = None,
                        graphs: bool = True) -> Callable:
    """A callable the worker thread invokes to construct its ServingModel
    (build_serving_model) and tokenizer. The device is resolved here, so
    building a factory without a device where CUDA is absent raises at once;
    a CUDA device becomes the worker thread's current device.
    tp: rank 0's TPContext, or the function that joins the group and gives
    it (tp.start's connect), called by the factory in the worker's thread."""
    device = resolve_device(device)

    def factory():
        if device.type == "cuda":
            torch.cuda.set_device(device)  # per thread: this worker's kernels
        ctx = tp() if callable(tp) else tp
        try:
            model = build_serving_model(model_config, batch_size, ctx, device=device, seed=seed,
                                        sampler_seed=sampler_seed, graphs=graphs)
        except BaseException:
            if ctx is not None:
                ctx.close()
            raise
        return model, WorldTokenizer(model_config.vocab_path)

    return factory


def _tp_device_groups(worker_num: int, tp: int, device, tp_devices) -> List[List[torch.device]]:
    """Each worker's tp devices: tp_devices (worker_num*tp of them, worker k's
    at k*tp..), else `device` for every rank, else CUDA devices 0..worker_num*tp-1,
    which must be visible (NCCL refuses two ranks on one card)."""
    n = worker_num * tp
    if tp_devices is None:
        if device is None:
            resolve_device(None)  # raises without CUDA
            visible = torch.cuda.device_count()
            if visible < n:
                raise ValueError(f"worker_num {worker_num} x tensor_parallel {tp} needs {n} "
                                 f"CUDA devices, {visible} visible")
            tp_devices = [torch.device("cuda", i) for i in range(n)]
        else:
            tp_devices = [device] * n
    if len(tp_devices) != n:
        raise ValueError(f"tp_devices: {len(tp_devices)} devices for worker_num {worker_num} x "
                         f"tensor_parallel {tp}")
    return [list(tp_devices[k * tp:(k + 1) * tp]) for k in range(worker_num)]


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
        self._tp_processes: List[Any] = []  # tensor-parallel ranks 1..tp-1

    async def init(self, worker_num: int, model_config: ModelLoadConfig,
                   batch_size: int = 32, *, load_timeout: float = 300.0,
                   decode_block_size: Optional[int] = None,
                   model_factory: Optional[Callable] = None, device=None,
                   warmup_programs: bool = False, state_pool_size: int = 0,
                   tensor_parallel: Optional[int] = None, tp_backend: Optional[str] = None,
                   tp_devices: Optional[Sequence] = None, tp_timeout: float = 300.0,
                   vote_timeout: float = hosts.VOTE_TIMEOUT, graphs: bool = True) -> None:
        """Spawn workers and wait for their worker_loaded handshake. Worker k
        runs on `device`, or on CUDA device k mod the device count when none is
        given; model_factory replaces the synthetic-model factory.
        warmup_programs: each worker runs every serving program once (on
        CUDA: captures its graphs) before it reports itself loaded.
        state_pool_size: rows of the device state pool for prefix snapshots,
        plus 4 of headroom for snapshot bursts that race the cache's
        releases; only with one worker (a handle is a row of one worker's
        pool), and otherwise snapshots go to the host.

        tensor_parallel (model_config.tensor_parallel unless given): ranks
        serving each worker's model (parallel/tp.py). Worker k's rank r runs
        on tp_devices[k*tp + r]: by default CUDA device k*tp + r (a
        ValueError before any process starts where fewer than worker_num*tp
        are visible), or `device` for every rank where one is given.
        tp_backend: the data groups', NCCL on CUDA and gloo on the CPU
        unless given; given at tensor_parallel 1, it runs the tp path over
        one-rank groups. tp_timeout: seconds a collective may wait. The
        model is built from model_config on every rank (seed k for worker
        k), so model_factory is not taken. graphs: the models built here run
        the serving programs as CUDA graphs (gloo on CUDA cannot be
        captured: graphs=False there, else ServingModel raises).

        Lockstep (model_config.lockstep): one worker over this host's rows
        of the global `batch_size`, which must divide by the number of
        hosts; with several hosts, on CUDA, tensor_parallel must equal the
        host's visible devices. Host i's sampler is seeded from 0 and i.
        vote_timeout: seconds a host waits at the vote."""
        if self.is_initialized:
            raise RuntimeError("Workers already initialized")
        if self.is_shutdown:
            raise RuntimeError("Engine has been shutdown")
        tp = model_config.tensor_parallel if tensor_parallel is None else tensor_parallel
        slot_range = vote = sampler_seed = None
        if model_config.lockstep:
            if worker_num != 1:
                raise ValueError("lockstep serving uses exactly one worker per host (the "
                                 "host's rows of the global batch)")
            host, dp = hosts.host_world() or (0, 1)
            if batch_size % dp:
                raise ValueError(f"batch_size {batch_size} must divide by the {dp} "
                                 "lockstep hosts")
            on_cuda = (tp_devices is None and model_factory is None
                       and (device is None or torch.device(device).type == "cuda"))
            if dp > 1 and on_cuda and tp != torch.cuda.device_count():
                raise ValueError(f"lockstep across {dp} hosts requires tensor_parallel == "
                                 f"the host's visible CUDA devices "
                                 f"({torch.cuda.device_count()}), got {tp}")
            batch_size //= dp
            slot_range = (host * batch_size, (host + 1) * batch_size)
            sampler_seed = hosts.sampler_seed(0, host)
        factories: List[Optional[Callable]] = [model_factory] * worker_num
        if tp > 1 or tp_backend is not None:
            if model_factory is not None:
                raise ValueError("tensor parallelism builds every rank's model from "
                                 "model_config; model_factory is not taken")
            groups = _tp_device_groups(worker_num, tp, device, tp_devices)
            try:
                for k, group in enumerate(groups):
                    build = functools.partial(build_serving_model, model_config, batch_size,
                                              seed=k, sampler_seed=sampler_seed, graphs=graphs)
                    connect, procs = tp_mod.start(tp, build, group, backend=tp_backend,
                                                  timeout=tp_timeout, name=f"w{k}")
                    self._tp_processes += procs
                    factories[k] = build_model_factory(
                        model_config, batch_size, device=group[0], seed=k, tp=connect,
                        sampler_seed=sampler_seed, graphs=graphs)
            except BaseException:
                self._stop_followers(0.0)
                raise
        devices = [device]
        if None in factories and device is None:
            resolve_device(None)  # raises without CUDA
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if model_config.lockstep and hosts.host_world() is not None:
            try:  # every host joins here: off the event loop
                vote = await asyncio.get_running_loop().run_in_executor(
                    None, hosts.vote_group, vote_timeout)
            except BaseException:
                self._stop_followers(0.0)
                raise
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
            factory = factories[k] or build_model_factory(
                model_config, batch_size, device=devices[k % len(devices)], seed=k,
                sampler_seed=sampler_seed, graphs=graphs)
            worker = Worker(worker_id=f"worker_{k}", model_factory=factory,
                            task_queue=self.task_queue, master_event_queue=master_q,
                            worker_event_queue=self.worker_event_queue,
                            batch_size=batch_size, decode_block_size=decode_block_size,
                            warmup_programs=warmup_programs, state_pool_size=pool_rows,
                            lockstep=model_config.lockstep, vote=vote, slot_range=slot_range)
            self.workers.append(worker)
            self.worker_threads.append(start_worker_thread(worker))

        loaded: set = set()
        loop = asyncio.get_running_loop()
        deadline = loop.time() + load_timeout
        while len(loaded) < worker_num:
            timeout = deadline - loop.time()
            if timeout <= 0:
                missing = {w.worker_id for w in self.workers} - loaded
                self._stop_followers(0.0)
                raise RuntimeError(f"workers failed to load in time: {missing}")
            dead = [p for p in self._tp_processes if not p.is_alive()]
            if dead:
                self._stop_followers(0.0)
                raise RuntimeError(f"tp ranks failed to load: {[p.name for p in dead]} "
                                   f"exited with {[p.exitcode for p in dead]}")
            try:
                worker_id, kind, payload = await asyncio.wait_for(
                    self.worker_event_queue.queue.get(), timeout=min(timeout, 1.0))
            except asyncio.TimeoutError:
                continue
            if kind == "worker_loaded":
                if payload.get("status") != "success":
                    self._stop_followers(0.0)
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
        """Join the worker threads, then the tp followers (the worker stops
        them as it exits), each within `timeout` seconds; a follower left is
        killed."""
        for t in self.worker_threads:
            t.join(timeout=timeout)
        self._stop_followers(10.0 if timeout is None else timeout)

    def _stop_followers(self, timeout: float) -> None:
        if self._tp_processes:
            tp_mod.stop(self._tp_processes, timeout)

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
