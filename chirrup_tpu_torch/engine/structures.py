"""Request/task structures for the serving engine.

Semantics mirror the reference engine's task model
(chirrup's core_structure.py): a Task is the unit of scheduling,
carrying prompt/prefill tokens, sampling parameters, stop/forbidden token sets,
prefix-cache options and its own output/event queues bridging the worker thread to
asyncio. A snapshot is a RequestState on the host (CPU tensors at the device's
dtype) or a PoolHandle to a row of a worker's device state pool, whose rows
StatePoolAllocator hands out and revokes under pressure.
"""

from __future__ import annotations

import dataclasses
import enum
import queue
import threading
import uuid
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

FINISH_REASON_STRINGS = ("stop", "length", "abort")

# token 0 = <|endoftext|>, 261 = '\n\n', 24281 = '\n\nUser' in the world vocab
# (reference core_structure.py:15)
DEFAULT_STOP_TOKENS = (0, 261, 24281)

DEFAULT_SAMPLING_CONFIG = {
    "temperature": 1.0,
    "top_p": 0.3,
    "top_k": 0,
    "presence_penalty": 0.5,
    "frequency_penalty": 0.5,
    "penalty_decay": 0.996,
    "max_tokens": 8192,
}

# digits / whitespace token ids exempt from repetition penalties
# (reference worker.py:173)
NO_PENALTY_TOKEN_IDS = frozenset({33, 10, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58})


class FinishReason(enum.IntEnum):
    STOP = 0
    LENGTH = 1
    ABORT = 2

    def __str__(self):
        return FINISH_REASON_STRINGS[self.value]


class RequestStatus(enum.IntEnum):
    WAITING = enum.auto()
    RUNNING = enum.auto()
    FINISHED = enum.auto()
    FINISHED_STOPPED = enum.auto()
    FINISHED_LENGTH_CAPPED = enum.auto()
    FINISHED_ABORTED = enum.auto()

    def __str__(self):
        return self.name

    @staticmethod
    def is_finished(status: "RequestStatus") -> bool:
        return status > RequestStatus.FINISHED

    @staticmethod
    def get_finished_reason(status: "RequestStatus") -> Optional[FinishReason]:
        return _FINISHED_REASON_MAP.get(status)


_FINISHED_REASON_MAP = {
    RequestStatus.FINISHED_STOPPED: FinishReason.STOP,
    RequestStatus.FINISHED_LENGTH_CAPPED: FinishReason.LENGTH,
    RequestStatus.FINISHED_ABORTED: FinishReason.ABORT,
}


def _nbytes(a) -> int:
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    return np.asarray(a).nbytes


@dataclasses.dataclass
class RequestState:
    """Host-side snapshot of one request's recurrent state (the unit the prefix
    state-cache stores; reference keeps a 3-tensor list, rwkv7.py:224-235).
    ServingModel.extract_slot makes CPU tensors at the state's device dtype
    (bf16 in serving); insert_slot also takes numpy arrays."""

    shift: torch.Tensor  # (L, 2, C)
    wkv: torch.Tensor    # (L, N, H*N)
    elapsed: int

    def nbytes(self) -> int:
        return _nbytes(self.shift) + _nbytes(self.wkv) + 8


class StatePoolAllocator:
    """Thread-safe free list over the rows of a worker's device state pool,
    and the EVICTABLE registry: the handles the prefix cache holds, oldest
    first (PrefixStateCache registers a handle when it stores it and
    refreshes it on a hit). When a snapshot finds no free row, the worker
    revokes the least recently used of them (evict_lru_and_alloc); a row
    that an in-flight resume also holds (refs > 1) is never revoked.

    One lock (reentrant) guards the free list, the registry and the
    refcounts of every handle of this allocator. A handle leaves the
    registry the moment it dies (released to zero refs, or revoked), and
    evict_lru_and_alloc hands the row it revokes to its caller without
    passing it through the free list, so one call revokes at most one row."""

    def __init__(self, size: int):
        self.lock = threading.RLock()
        self._free = list(range(size - 1, -1, -1))
        self.size = size
        # insertion order == eviction order (oldest first)
        self._evictable: "OrderedDict[PoolHandle, None]" = OrderedDict()

    def alloc(self) -> Optional[int]:
        with self.lock:
            return self._free.pop() if self._free else None

    def free(self, row: int) -> None:
        with self.lock:
            self._free.append(row)

    def available(self) -> int:
        with self.lock:
            return len(self._free)

    def note_evictable(self, handle: "PoolHandle") -> None:
        """Register (or refresh) a cache-held handle as revocable under
        pressure; a dead handle is not registered."""
        with self.lock:
            self._evictable.pop(handle, None)
            if handle.refs > 0 and not handle.revoked:
                self._evictable[handle] = None

    def touch_evictable(self, handle: "PoolHandle") -> None:
        with self.lock:
            if handle in self._evictable:
                self._evictable.move_to_end(handle)

    def evict_lru_and_alloc(self) -> Optional[int]:
        """A row for a snapshot when alloc() found none: a row freed
        meanwhile, else the row of the oldest registered handle that only
        the cache holds (refs == 1), revoked and handed to the caller (its
        cache entry turns into a miss at its next lookup). None when every
        registered handle is pinned by an in-flight resume."""
        with self.lock:
            if self._free:
                return self._free.pop()
            for handle in self._evictable:
                if handle.refs == 1:
                    handle.refs = 0
                    handle.revoked = True
                    del self._evictable[handle]
                    return handle.row
        return None


@dataclasses.dataclass(eq=False)
class PoolHandle:
    """A prefix-state snapshot in one row of a worker's device state pool
    (ServingModel.init_state_pool): resuming from it is a device-to-device
    copy (ServingModel.pool_load), where a host RequestState costs a round
    trip of the row's bytes over PCIe.

    Refcounted: the holder of the snapshot event owns one reference (the
    prefix cache, when it stores the handle); each in-flight resume holds
    another, which the worker releases once it has loaded the row. The row
    returns to the free list when the last reference goes. Handles compare
    and hash by identity."""

    row: int
    worker_id: str
    allocator: StatePoolAllocator
    device_bytes: int = 0
    refs: int = 1
    # True once evict_lru_and_alloc took the row from the cache (only while
    # refs == 1); the cache drops revoked entries at lookup
    revoked: bool = False

    @property
    def alive(self) -> bool:
        return self.refs > 0 and not self.revoked

    def try_acquire(self) -> bool:
        """A reference more (an in-flight resume's), or False when the handle
        is dead: released, or revoked between a cache lookup and this call
        (the worker's revocation races with every resume)."""
        with self.allocator.lock:
            if self.revoked or self.refs <= 0:
                return False
            self.refs += 1
            return True

    def release(self) -> None:
        """Drop one reference; the last one frees the row and takes the
        handle out of the registry. A revoked handle's row is already
        someone else's: nothing to do."""
        alloc = self.allocator
        with alloc.lock:
            if self.revoked or self.refs <= 0:
                return
            self.refs -= 1
            if self.refs == 0:
                alloc._evictable.pop(self, None)
                alloc.free(self.row)

    def try_revoke(self) -> bool:
        """Recycle the row now if the cache is its only holder (refs == 1):
        the row returns to the free list and the handle leaves the
        registry. Pinned (refs > 1) and dead handles refuse."""
        alloc = self.allocator
        with alloc.lock:
            if self.revoked or self.refs != 1:
                return False
            self.revoked = True
            self.refs = 0
            alloc._evictable.pop(self, None)
            alloc.free(self.row)
            return True

    def mark_evictable(self) -> None:
        """Called by the prefix cache when it stores this handle."""
        self.allocator.note_evictable(self)

    def touch_evictable(self) -> None:
        """Called by the prefix cache on a lookup hit (recency refresh)."""
        self.allocator.touch_evictable(self)

    def nbytes(self) -> int:
        return self.device_bytes  # device-pool bytes


@dataclasses.dataclass
class Task:
    """One generation request moving through the engine."""

    output_queue: Any                  # ThreadSafeAsyncQueue-like (put_nowait)
    task_event_queue: queue.Queue      # abort channel (thread-safe)
    prompt_str: str
    prefill_tokens: List[int]
    # the snapshot to resume from: a host RequestState or a PoolHandle of the
    # worker's device state pool (the worker consumes the handle's reference)
    state: Union[RequestState, PoolHandle, None]
    task_id: Optional[str] = None
    priority: int = 0

    temperature: float = DEFAULT_SAMPLING_CONFIG["temperature"]
    top_p: float = DEFAULT_SAMPLING_CONFIG["top_p"]
    top_k: int = DEFAULT_SAMPLING_CONFIG["top_k"]
    presence_penalty: float = DEFAULT_SAMPLING_CONFIG["presence_penalty"]
    frequency_penalty: float = DEFAULT_SAMPLING_CONFIG["frequency_penalty"]
    penalty_decay: float = DEFAULT_SAMPLING_CONFIG["penalty_decay"]
    max_tokens: Optional[int] = DEFAULT_SAMPLING_CONFIG["max_tokens"]

    stop_tokens: Sequence[int] = DEFAULT_STOP_TOKENS
    forbidden_tokens: Sequence[int] = ()

    cache_prefill: bool = False
    cache_prefill_padding: int = 0
    return_logits: bool = False

    request_status: RequestStatus = dataclasses.field(
        init=False, default=RequestStatus.WAITING)
    generated_tokens: List[int] = dataclasses.field(init=False, default_factory=list)
    decoded_texts: List[str] = dataclasses.field(init=False, default_factory=list)
    # TTFT attribution timestamps (time.time()): "enqueue" (interface submit),
    # "admit" (worker slot fill), "first_token" (first sampled token read) —
    # lets /metrics decompose the TTFT tail into queue-wait vs prefill+decode
    timing: Dict[str, float] = dataclasses.field(init=False,
                                                 default_factory=dict)

    def __post_init__(self):
        if self.task_id is None:
            self.task_id = str(uuid.uuid4())
        self.stop_tokens = set(self.stop_tokens)

    def is_finished(self) -> bool:
        return RequestStatus.is_finished(self.request_status)


@dataclasses.dataclass
class ModelLoadConfig:
    """What the worker needs to load and run a model."""

    model_path: str
    vocab_path: str
    vocab_size: int = 65536
    head_size: int = 64
    # runtime knobs
    quantization: Optional[str] = "int8"   # None | "int8"
    wkv_state_dtype: str = "bfloat16"      # "float32" | "bfloat16"
    activation_dtype: str = "bfloat16"
    # the int8 GEMM under "int8" (RuntimeConfig.mm8_core): "auto" (w8a8) or
    # "pallas" (w8a16)
    mm8_core: str = "auto"
    # tokens per row of a prefill chunk (ServingModel.prefill_chunk)
    prefill_chunk: int = 64
    # test and benchmark hook: synthetic model instead of a checkpoint file
    synthetic_config: Optional[Dict[str, int]] = None
