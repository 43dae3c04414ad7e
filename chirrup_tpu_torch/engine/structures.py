"""Request/task structures for the serving engine.

Semantics mirror the reference engine's task model
(chirrup's core_structure.py): a Task is the unit of scheduling,
carrying prompt/prefill tokens, sampling parameters, stop/forbidden token sets,
prefix-cache options and its own output/event queues bridging the worker thread to
asyncio. States are host-side snapshots: CPU tensors at the device's dtype
(device residency is the worker's business, not the task's).
"""

from __future__ import annotations

import dataclasses
import enum
import queue
import uuid
from typing import Any, Dict, List, Optional, Sequence

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


@dataclasses.dataclass
class Task:
    """One generation request moving through the engine."""

    output_queue: Any                  # ThreadSafeAsyncQueue-like (put_nowait)
    task_event_queue: queue.Queue      # abort channel (thread-safe)
    prompt_str: str
    prefill_tokens: List[int]
    state: Optional[RequestState]
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
