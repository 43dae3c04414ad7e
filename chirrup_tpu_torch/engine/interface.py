"""AsyncEngineCompletion — async iterator over one generation request's events.

Same event contract as the reference (chirrup's interface.py):
("token", id, text[, logits]) / ("cache_prefill", {...}) / StopAsyncIteration on
completion. abort() enqueues an abort signal the worker polls every loop.
"""

from __future__ import annotations

import asyncio
import queue
import time
from typing import Any, List, Optional, Sequence, Union

from chirrup_tpu_torch.engine.structures import (
    DEFAULT_SAMPLING_CONFIG, DEFAULT_STOP_TOKENS, PoolHandle, RequestState, Task)


class AsyncEngineCompletion:
    """Controller for a single streaming generation request."""

    def __init__(
        self,
        prompt_str: str,
        prefill_tokens: List[int],
        state: Union[RequestState, PoolHandle, None],
        task_queue: "queue.Queue[Task]",
        result_channel: Any,
        task_id: str,
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
        cache_prefill: bool = False,
        cache_prefill_padding: int = 0,
        return_logits: bool = False,
    ):
        self.task_id = task_id
        self.task_event_queue: queue.Queue = queue.Queue()
        self._result_channel = result_channel
        self._result_queue: asyncio.Queue = result_channel.queue

        self.task = Task(
            task_id=task_id,
            priority=priority,
            temperature=temperature,
            top_p=top_p,
            top_k=top_k,
            presence_penalty=presence_penalty,
            frequency_penalty=frequency_penalty,
            penalty_decay=penalty_decay,
            stop_tokens=tuple(stop_tokens) if stop_tokens else (),
            max_tokens=max_tokens,
            prompt_str=prompt_str,
            prefill_tokens=prefill_tokens,
            state=state,
            output_queue=result_channel,
            task_event_queue=self.task_event_queue,
            forbidden_tokens=tuple(forbidden_tokens),
            cache_prefill=cache_prefill,
            cache_prefill_padding=cache_prefill_padding,
            return_logits=return_logits,
        )
        self._task_queue = task_queue
        self._submitted = False
        self.is_finished = False
        self._token_buffer: List[tuple] = []  # coalesced-event fan-out

    def start(self):
        self._submitted = True
        self.task.timing["enqueue"] = time.time()
        self._task_queue.put_nowait(self.task)

    def __aiter__(self):
        if not self._submitted:
            self.start()
        return self

    async def __anext__(self):
        if self.is_finished:
            raise RuntimeError("Already finished")
        if self._token_buffer:
            return self._token_buffer.pop(0)
        while True:
            out = await self._result_queue.get()
            if isinstance(out, tuple) and len(out) == 2:
                message_type, payload = out
                if message_type == "token_generated":
                    return ("token", *payload)
                if message_type == "tokens_generated":
                    # one coalesced event per slot per decode block (the
                    # per-token bridge wakeups measured as real host overhead
                    # at thousands of tok/s); fan back out per token here so
                    # the public event contract is unchanged
                    self._token_buffer = [("token", *p) for p in payload]
                    if self._token_buffer:
                        return self._token_buffer.pop(0)
                    continue
                if message_type == "task_completed":
                    self.is_finished = True
                    self.task = payload
                    raise StopAsyncIteration
                if message_type == "cache_prefill":
                    return ("cache_prefill", payload)

    def drain_buffered(self) -> List[tuple]:
        """Pop every already-buffered ("token", ...) event WITHOUT awaiting —
        after one __anext__ returns the first token of a coalesced block, the
        rest are host-resident; consumers that can handle a batch (the SSE
        handler) take them all in one pass instead of K await round trips
        (each await is an event-loop task switch; at thousands of tok/s over
        hundreds of streams those switches saturated the loop)."""
        out, self._token_buffer = self._token_buffer, []
        return out

    def get_full_completion(self) -> "asyncio.Task[str]":
        async def fetch_all() -> str:
            parts: List[str] = []
            async for event in self:
                if event[0] == "token":
                    parts.append(event[2])
            return "".join(parts)

        return asyncio.create_task(fetch_all())

    def abort(self):
        self.task_event_queue.put_nowait(("abort", None))
