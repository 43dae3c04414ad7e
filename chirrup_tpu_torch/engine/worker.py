"""Continuous-batching worker: one thread driving one device.

Slots are never physically reordered: the step functions take boolean masks
over a fixed-size batch, so a slot's position never changes. A prompt with at
least `min_forward_seq_len` tokens after its first is admitted as SEQ_PREFILL
and advanced in chunks of up to `prefill_chunk` tokens per row
(ServingModel.prefill_step_compact), at most `max_prefill_count` prompts at a
time; its last tokens, and shorter prompts, are fed token by token through the
decode block as ONE_PREFILL before the slot turns to DECODE. Each loop
dispatches one decode block of K steps (K > 1 on the GPU, where a block
amortises the host's per-step work), then prefill chunks at one chunk per
`decode_prefill_ratio` decode steps, then reads the previous block's sampled
tokens, once per block.

Prefix snapshots: a task with cache_prefill is snapshotted where
cache_prefill_padding - 1 prompt tokens are left (pad()): into a row of the
worker's device state pool (a PoolHandle), or, with no pool, to the host
through ServingModel.extract_slot_async (a RequestState, resolved at the top
of the next loop). The block planner pauses only that slot at its boundary.
A task whose `state` is a PoolHandle of this worker is admitted with the
zero state and then loads its row; a host RequestState goes through
insert_slot.

Lockstep (`lockstep=True`, one worker per host, the counterpart of the JAX
worker's lockstep paths): the worker serves its host's rows `slot_range`
of the global batch; its carry holds those rows alone. Every loop it
dispatches one decode block, even with no active slot (K = 1 while a slot
wants per-step logits, which the block gathers as marked rows), runs at
most one prefill chunk when the countdown is due, and at its one host read
of the block all-reduces the block's vote sums over the hosts' vote group
(parallel/hosts.py): column 0 counts shutdown votes, column 1 the rows
with a task. Every host sees the same counts at the same loop: a shutdown
voted on any host stops every host after that loop (each aborts its
remaining tasks), and when no host has a task every host idles for the
same loop. No program spans hosts, so an admission, a resume or a snapshot
needs no round between them: each runs on the host's own rows as it does
without lockstep. A failure in lockstep (a peer that died, the vote's
timeout) stops the worker: the hosts can no longer keep in step.
"""

from __future__ import annotations

import dataclasses
import enum
import queue
import threading
import time
import traceback
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from chirrup_tpu_torch.engine.serving import ServingModel, slot_params
from chirrup_tpu_torch.engine.structures import (PoolHandle, RequestStatus,
                                                 StatePoolAllocator, Task)
from chirrup_tpu_torch.utils.tokenizer import StreamingDecoder, WorldTokenizer

# steps per dispatch on the GPU (the CPU runs single steps)
GPU_DECODE_BLOCK = 16


class SlotPhase(enum.IntEnum):
    EMPTY = 0
    SEQ_PREFILL = 1   # chunked prompt prefill (prefill_step_compact)
    ONE_PREFILL = 2   # token-by-token prompt ingestion through the decode block
    DECODE = 3        # sampling


_STEPPED = (SlotPhase.ONE_PREFILL, SlotPhase.DECODE)  # phases the decode block runs


@dataclasses.dataclass
class SlotData:
    task: Optional[Task] = None
    phase: SlotPhase = SlotPhase.EMPTY
    next_input: Optional[int] = None
    decoder: Optional[StreamingDecoder] = None
    # True once the slot's decode input comes from the device-side feedback
    # (BatchCarry.last_sampled) instead of a host-provided token
    use_feedback: bool = False
    # every prompt token fed so far (the snapshot's key) and whether the
    # snapshot was taken
    prefilled_tokens: List[int] = dataclasses.field(default_factory=list)
    prefill_cached: bool = False

    def pad(self) -> int:
        """Prompt tokens left unfed at the snapshot boundary."""
        return max(self.task.cache_prefill_padding - 1, 0) if self.task else 0

    def at_boundary(self) -> bool:
        """The slot is at its snapshot boundary and not yet snapshotted."""
        task = self.task
        return (task.cache_prefill and not self.prefill_cached
                and len(task.prefill_tokens) == self.pad())


@dataclasses.dataclass
class _PendingStep:
    """A dispatched decode step/block whose sampled tokens have not been read yet."""

    sampled: Any         # (B,) for single steps, (K, B) for blocks — device tensors
    # the raw logits by slot: (B, V) for single steps, {slot: (V,)} for a
    # lockstep block's marked rows, None otherwise
    raw_logits: Any
    decode_slots: List[Tuple[int, str]]  # (slot index, task_id at dispatch)
    votes: Any = None    # a lockstep block's (2,) vote sums on the device


class Worker:
    """Runs the continuous-batching loop in its own thread."""

    # a prompt with at least this many tokens after its first prefills in chunks
    min_forward_seq_len = 10
    # decode steps per prefill chunk while both run
    decode_prefill_ratio = 5

    def __init__(self, worker_id: str,
                 model_factory: Callable[[], Tuple[ServingModel, WorldTokenizer]],
                 task_queue: "queue.Queue[Task]", master_event_queue: queue.Queue,
                 worker_event_queue: Any, batch_size: int = 32,
                 decode_block_size: Optional[int] = None, idle_sleep: float = 0.05,
                 warmup_programs: bool = False, state_pool_size: int = 0,
                 lockstep: bool = False, vote=None,
                 slot_range: Optional[Tuple[int, int]] = None):
        self.worker_id = worker_id
        self._model_factory = model_factory
        self.task_queue = task_queue
        self.master_event_queue = master_event_queue
        self.worker_event_queue = worker_event_queue
        self.batch_size = batch_size
        # concurrent chunked prefills; capped by the model's prefill_slots
        self.max_prefill_count = max(int(batch_size * 0.125), 1)
        self.decode_block_size = decode_block_size  # None = by device
        self.idle_sleep = idle_sleep
        # run (on CUDA: capture) every serving program before the first request
        self.warmup_programs = warmup_programs

        self.slots: List[SlotData] = [SlotData() for _ in range(batch_size)]
        self.model: Optional[ServingModel] = None
        self.tokenizer: Optional[WorldTokenizer] = None
        self.carry = None
        self.shutdown_flag = False
        self._loop_times: deque = deque(maxlen=10)
        self.loop_count = 0
        self._pending: Optional[_PendingStep] = None
        # decode steps owed before the next prefill chunk
        self._seq_countdown = 0
        # long prompts over the prefill cap, retried first at the next fill
        self._deferred_tasks: List[Task] = []
        # the device state pool (init_state_pool) and its rows' allocator
        self.state_pool_size = state_pool_size
        self.pool_allocator: Optional[StatePoolAllocator] = None
        self.state_pool = None
        self.snapshot_skips = 0      # pool exhausted, every row pinned
        self.snapshot_evictions = 0  # cache-held rows revoked for a snapshot
        # pool snapshots (slot, row) queued for one pool_store_many
        self._snapshot_batch: List[Tuple[int, int]] = []
        # host snapshots (task, key, resolver) copying during the next block
        self._pending_snapshots: List[Tuple[Task, Tuple[int, ...], Callable]] = []
        # lockstep: the hosts' vote group (None: one host), this host's rows
        # of the global batch, this host's shutdown vote, the last counts
        # every host saw, and the vote's host seconds and loops
        self.lockstep = lockstep
        self.vote = vote
        self.slot_range = slot_range or (0, batch_size)
        self._stop_vote = False
        self.vote_counts: Optional[np.ndarray] = None
        self.vote_seconds = 0.0
        self.vote_loops = 0
        # decode steps dispatched and prefill chunks run (telemetry: with the
        # kernels' launch counts, launches a step and a chunk)
        self.steps_run = 0
        self.chunks_run = 0

    # ------------------------------------------------------------------ setup

    def _init_worker(self):
        self.model, self.tokenizer = self._model_factory()
        if self.model.batch_size != self.batch_size:
            raise ValueError(f"the model serves {self.model.batch_size} rows, the worker "
                             f"{self.batch_size}")
        self.carry = self.model.init_carry()
        self.max_prefill_count = min(self.max_prefill_count, self.model.prefill_slots)
        if self.decode_block_size is None:
            self.decode_block_size = (GPU_DECODE_BLOCK if self.model.device.type == "cuda"
                                      else 1)
        if self.state_pool_size > 0:
            self.state_pool = self.model.init_state_pool(self.state_pool_size)
            self.pool_allocator = StatePoolAllocator(self.state_pool_size)

    def _warmup_programs(self):
        """Run every serving program once on all-inactive inputs before the
        first request: decode_block at the worker's K (when K > 1),
        decode_step, each compact prefill variant and the batched insert;
        with a state pool, one pool_store_many of slot 0 into row 0 and one
        pool_load back. On CUDA this captures their graphs (ServingModel),
        which otherwise happens mid-serving the first time each program
        shape is hit. All-inactive masks, zero lengths, an all-False insert
        mask and the zero slot's round trip leave the carry exactly as it
        is; only the sampler's generator advances."""
        m, B = self.model, self.batch_size
        K = max(self.decode_block_size, 1)
        t0 = time.time()
        if K > 1 or self.lockstep:
            fK = np.zeros((K, B), bool)
            self.carry, _, _ = m.decode_block(self.carry, np.zeros((K, B), np.int32), fK, fK,
                                              fK)
        self.carry, _, _ = m.decode_step(self.carry, np.zeros((B,), np.int32),
                                         np.zeros((B,), bool), np.zeros((B,), bool))
        for P, T in m.prefill_variants:
            self.carry = m.prefill_step_compact(self.carry, np.zeros((P, T), np.int32),
                                                np.zeros((P,), np.int32),
                                                np.arange(P, dtype=np.int32))
        self.carry = m.insert_slots_batched(self.carry, np.zeros((B,), bool), [None] * B)
        if self.state_pool is not None:
            self.state_pool = m.pool_store_many(self.carry, self.state_pool, [(0, 0)])
            self.carry = m.pool_load(self.carry, self.state_pool, 0, 0)
        if m.device.type == "cuda":
            torch.cuda.synchronize(m.device)
        print(f"[{self.worker_id}] serving programs warmed in {time.time() - t0:.1f}s"
              + (" (captured as CUDA graphs)" if m.graphs else ""), flush=True)

    def _emit_worker_event(self, kind: str, payload: Dict):
        if self.worker_event_queue is not None:
            self.worker_event_queue.put_nowait((self.worker_id, kind, payload))

    # ------------------------------------------------------------- lifecycle

    def _process_master_events(self) -> bool:
        while True:
            try:
                event = self.master_event_queue.get_nowait()
            except queue.Empty:
                return False
            if isinstance(event, dict) and event.get("type") == "shutdown":
                if self.lockstep:
                    # a host that stopped alone would leave the others
                    # waiting at the next vote: vote, and stop with them
                    self._stop_vote = True
                    return False
                self.shutdown_flag = True
                return True

    @staticmethod
    def _is_aborted(task: Task) -> bool:
        try:
            event_type, _ = task.task_event_queue.get_nowait()
            return event_type == "abort"
        except queue.Empty:
            return False

    def _finish_slot(self, idx: int):
        """Free the slot. No device work: a freed slot is masked out of every
        step, and the insert that reuses it reinitialises all its rows."""
        task = self.slots[idx].task
        task.output_queue.put_nowait(("task_completed", task))
        self.slots[idx] = SlotData()

    # ------------------------------------------------------------------ fill

    def _one_prefill_burst_max(self) -> int:
        """Longest remaining prompt admitted as ONE_PREFILL while the chunked
        prefills are at their cap: about four decode blocks of token-by-token
        ingestion. Longer prompts wait for a prefill row."""
        return 4 * max(self.decode_block_size or 1, 1)

    def _fail(self, task: Task) -> None:
        """End a task that was never admitted, with a completion event; a
        PoolHandle it brought gives back the reference it carried."""
        if isinstance(task.state, PoolHandle):
            task.state.release()
        task.request_status = RequestStatus.FINISHED_ABORTED
        task.output_queue.put_nowait(("task_completed", task))

    def _fill_slots(self):
        """Admit queued tasks into empty slots. Only prompts bound for
        SEQ_PREFILL count against max_prefill_count, and only once admitted
        (the remaining length is the one left after the first token and the
        snapshot's pad). With the cap full, a prompt within
        _one_prefill_burst_max rides the decode block as ONE_PREFILL; a
        longer one goes back to the front of the line, and shorter prompts
        behind it are still admitted.

        Fresh tasks and resumes from this worker's pool, with at most
        LOCKSTEP_MAX_FORBIDDEN forbidden ids, are admitted together by one
        insert_slots_batched; then each pool resume loads its row
        (pool_load) and releases the handle's reference. A host RequestState
        and a longer forbidden set go through insert_slot. A PoolHandle of
        another worker, or one given while the pool is off, fails its task."""
        B = self.batch_size
        batch_mask = np.zeros((B,), bool)
        batch_tasks: List[Optional[Task]] = [None] * B
        pool_loads: List[Tuple[int, PoolHandle]] = []
        prefill_count = sum(1 for s in self.slots if s.phase == SlotPhase.SEQ_PREFILL)
        deferred_now: List[Task] = []
        for idx in range(B):
            if self.slots[idx].phase != SlotPhase.EMPTY:
                continue
            if self._deferred_tasks:
                task = self._deferred_tasks.pop(0)
            else:
                try:
                    task = self.task_queue.get_nowait()
                except queue.Empty:
                    break
            if not task.prefill_tokens:
                self._fail(task)  # an empty prompt fails itself
                continue
            pad = max(task.cache_prefill_padding - 1, 0)
            remaining = len(task.prefill_tokens) - 1 - pad
            seq_bound = remaining >= self.min_forward_seq_len
            if seq_bound and prefill_count >= self.max_prefill_count:
                if remaining > self._one_prefill_burst_max():
                    deferred_now.append(task)
                    continue
                seq_bound = False
            pool_resume = (isinstance(task.state, PoolHandle) and self.state_pool is not None
                           and task.state.worker_id == self.worker_id)
            if isinstance(task.state, PoolHandle) and not pool_resume:
                # its rows are in another worker's pool (or none), and the
                # prompt was already cut to the suffix: nothing to resume from
                self._fail(task)
                continue
            try:
                simple = ((task.state is None or pool_resume) and len(task.forbidden_tokens)
                          <= ServingModel.LOCKSTEP_MAX_FORBIDDEN)
                if simple:
                    slot_params(task)  # a malformed task fails here, alone
                else:
                    self.carry = self.model.insert_slot(
                        self.carry, idx, None if pool_resume else task.state, task)
            except Exception:  # noqa: BLE001 — a malformed task fails itself,
                # with a completion event, and takes no prefill row
                traceback.print_exc()
                self._fail(task)
                continue
            if simple:
                batch_mask[idx] = True
                batch_tasks[idx] = task
            if pool_resume:
                pool_loads.append((idx, task.state))
            task.request_status = RequestStatus.RUNNING
            next_input = task.prefill_tokens.pop(0)
            if not task.prefill_tokens:
                phase = SlotPhase.DECODE
            elif seq_bound:
                phase = SlotPhase.SEQ_PREFILL
                prefill_count += 1
            else:
                phase = SlotPhase.ONE_PREFILL
            task.timing["admit"] = time.time()
            self.slots[idx] = SlotData(task=task, phase=phase, next_input=next_input,
                                       decoder=StreamingDecoder(self.tokenizer))
        self._deferred_tasks = deferred_now + self._deferred_tasks
        if batch_mask.any():
            self.carry = self.model.insert_slots_batched(self.carry, batch_mask, batch_tasks)
        for idx, handle in pool_loads:
            # the row over the freshly inserted zero state, on the device
            self.carry = self.model.pool_load(self.carry, self.state_pool, handle.row, idx)
            handle.release()

    def _check_seq_transitions(self):
        """A SEQ_PREFILL slot at its snapshot boundary is snapshotted; one
        with fewer than min_forward_seq_len prompt tokens left beyond its pad
        finishes them as ONE_PREFILL (DECODE when none is left). The
        remaining length is pad-adjusted, as the chunks stop pad() tokens
        early: a padding of min_forward_seq_len or more would otherwise keep
        the slot in SEQ_PREFILL with nothing left to chunk."""
        for idx, slot in enumerate(self.slots):
            if slot.phase != SlotPhase.SEQ_PREFILL:
                continue
            if slot.at_boundary():
                self._maybe_snapshot(idx)
            # then the phase decision: with padding 0 the boundary is the
            # end of the prompt, and the slot goes to DECODE
            task = slot.task
            if not task.prefill_tokens:
                slot.phase = SlotPhase.DECODE
            elif len(task.prefill_tokens) - slot.pad() < self.min_forward_seq_len:
                slot.phase = SlotPhase.ONE_PREFILL

    # ------------------------------------------------------------- snapshots

    def _pool_alloc(self) -> Optional[int]:
        """A pool row for a snapshot: the free list, else the row of the
        cache's least recently used unpinned handle (revoked; the cache
        turns its entry into a miss at the next lookup). None when every
        cache-held row is pinned by an in-flight resume."""
        row = self.pool_allocator.alloc()
        if row is None:
            row = self.pool_allocator.evict_lru_and_alloc()
            if row is not None:
                self.snapshot_evictions += 1
        return row

    def _snapshot_slot(self, idx: int):
        """Snapshot a slot at its boundary: into a pool row (queued for one
        pool_store_many, _flush_snapshot_batch), or with no pool to the host
        (extract_slot_async now, the event at the top of the next loop). A
        pool with no row to give skips the snapshot with a state-None event,
        so the request's deduplicated followers prefill at once."""
        slot = self.slots[idx]
        slot.prefill_cached = True
        key = tuple(slot.prefilled_tokens)
        if self.state_pool is None:
            self._pending_snapshots.append(
                (slot.task, key, self.model.extract_slot_async(self.carry, idx)))
            return
        row = self._pool_alloc()
        if row is None:
            self.snapshot_skips += 1
            slot.task.output_queue.put_nowait(
                ("cache_prefill", {"state": None, "prefilled_tokens": key}))
            return
        self._snapshot_batch.append((idx, row))

    def _flush_snapshot_batch(self):
        """Store the queued pool snapshots with one pool_store_many and send
        their events. Runs before the next dispatch that advances state, so
        each snapshot holds its slot exactly at its boundary."""
        if not self._snapshot_batch:
            return
        batch, self._snapshot_batch = self._snapshot_batch, []
        self.state_pool = self.model.pool_store_many(self.carry, self.state_pool, batch)
        row_bytes = self.model.pool_row_bytes()
        for idx, row in batch:
            slot = self.slots[idx]
            handle = PoolHandle(row=row, worker_id=self.worker_id,
                                allocator=self.pool_allocator, device_bytes=row_bytes)
            if slot.task is None or slot.task.is_finished():
                handle.release()
                continue
            slot.task.output_queue.put_nowait(("cache_prefill", {
                "state": handle, "prefilled_tokens": tuple(slot.prefilled_tokens)}))

    def _emit_ready_snapshots(self):
        """Resolve the host snapshots started last loop (their copies ran
        beside the block dispatched since) and send their events. A failed
        copy is a device fault: it raises, as every other one does."""
        pending, self._pending_snapshots = self._pending_snapshots, []
        for task, key, resolve in pending:
            state = resolve()
            if not task.is_finished():
                task.output_queue.put_nowait(
                    ("cache_prefill", {"state": state, "prefilled_tokens": key}))

    def _maybe_snapshot(self, idx: int):
        if self.slots[idx].at_boundary():
            self._snapshot_slot(idx)

    # ---------------------------------------------------------------- forward

    def _choose_block_size(self) -> int:
        """K steps per dispatch; 1 while a slot wants per-step raw logits
        (return_logits), which only single steps return."""
        K = self.decode_block_size
        if K <= 1:
            return 1
        for slot in self.slots:
            if slot.phase in _STEPPED and slot.task.return_logits:
                return 1
        return K

    def _dispatch_decode_block(self, K: int):
        """Plan and dispatch K decode steps in one call. Prompt feeds and the
        ONE_PREFILL -> DECODE transitions are known K steps ahead on the host;
        DECODE inputs chain through the device-resident last_sampled. A slot
        that reaches its snapshot boundary idles for the rest of the block
        (inactive, its state kept bit for bit, as any inactive row's) and is
        snapshotted right after the dispatch; the other slots run all K
        steps (a block demoted to K = 1 would slow the whole batch, as some
        slot is near a boundary most of the time under load)."""
        B = self.batch_size
        tokens = np.zeros((K, B), np.int32)
        feedback = np.zeros((K, B), bool)
        active = np.zeros((K, B), bool)
        decode = np.zeros((K, B), bool)
        decode_slots: List[Tuple[int, str]] = []
        n_active = n_decode = 0
        for idx, slot in enumerate(self.slots):
            if slot.phase not in _STEPPED:
                continue
            task = slot.task
            n_active += 1
            phase = slot.phase
            if phase == SlotPhase.DECODE:
                n_decode += 1
                decode_slots.append((idx, task.task_id))
            for k in range(K):
                if slot.at_boundary():
                    break  # paused until the snapshot after this dispatch
                active[k, idx] = True
                if phase == SlotPhase.ONE_PREFILL:
                    tokens[k, idx] = slot.next_input
                    slot.prefilled_tokens.append(slot.next_input)
                    slot.next_input = task.prefill_tokens.pop(0)
                    if not task.prefill_tokens:
                        phase = SlotPhase.DECODE
                else:
                    decode[k, idx] = True
                    if slot.use_feedback:
                        feedback[k, idx] = True
                    else:
                        tokens[k, idx] = slot.next_input
                        slot.use_feedback = True
            if phase == SlotPhase.DECODE and slot.phase == SlotPhase.ONE_PREFILL:
                slot.phase = SlotPhase.DECODE
                decode_slots.append((idx, task.task_id))
        votes = logit_rows = raw_logits = None
        if self.lockstep:
            votes = np.zeros((B, 2), np.int32)
            votes[:, 0] = self._stop_vote
            votes[:, 1] = [s.task is not None for s in self.slots]
            marks = [idx for idx, slot in enumerate(self.slots)
                     if active[:, idx].any() and slot.task.return_logits]
            if marks:
                logit_rows = np.array(marks, np.int32)
        out = self.model.decode_block(self.carry, tokens, feedback, active, decode, votes,
                                      logit_rows)
        self.carry, sampled = out[0], out[1]
        if logit_rows is not None:
            raw_logits = {idx: out[3][K - 1, m] for m, idx in enumerate(marks)}
        for idx, slot in enumerate(self.slots):
            if slot.phase in _STEPPED:
                self._maybe_snapshot(idx)
        self._pending = _PendingStep(sampled=sampled, raw_logits=raw_logits,
                                     decode_slots=decode_slots,
                                     votes=out[2] if self.lockstep else None)
        return n_active, n_decode

    def _dispatch_decode_step(self):
        """One token step for every DECODE + ONE_PREFILL slot; DECODE slots read
        their input from the previous step's on-device sample."""
        B = self.batch_size
        tokens = np.zeros((B,), np.int32)
        feedback = np.zeros((B,), bool)
        active = np.zeros((B,), bool)
        decode = np.zeros((B,), bool)
        decode_slots: List[Tuple[int, str]] = []
        for idx, slot in enumerate(self.slots):
            if slot.phase not in _STEPPED:
                continue
            active[idx] = True
            if slot.phase == SlotPhase.DECODE:
                decode[idx] = True
                decode_slots.append((idx, slot.task.task_id))
                if slot.use_feedback:
                    feedback[idx] = True
                else:
                    tokens[idx] = slot.next_input
                    slot.use_feedback = True
            else:
                tokens[idx] = slot.next_input
        self.carry, sampled, raw_logits = self.model.decode_step(
            self.carry, tokens, active, decode, feedback)
        for idx, slot in enumerate(self.slots):
            if active[idx] and slot.phase == SlotPhase.ONE_PREFILL:
                slot.prefilled_tokens.append(slot.next_input)
                slot.next_input = slot.task.prefill_tokens.pop(0)
                if not slot.task.prefill_tokens:
                    slot.phase = SlotPhase.DECODE
                self._maybe_snapshot(idx)  # after the step: its state is in order
        self._pending = _PendingStep(sampled=sampled, raw_logits=raw_logits,
                                     decode_slots=decode_slots)
        return int(active.sum()), int(decode.sum())

    def _run_prefill_step(self) -> int:
        """One chunk for every SEQ_PREFILL slot, on the smallest compact (P, T)
        variant that holds them (max_prefill_count <= the largest P); returns
        the slots fed. Each slot keeps its pad() tokens and one more for the
        ONE_PREFILL/DECODE tail."""
        seq_ids = [idx for idx, slot in enumerate(self.slots)
                   if slot.phase == SlotPhase.SEQ_PREFILL
                   and len(slot.task.prefill_tokens) > slot.pad()]
        if not seq_ids:
            return 0
        P, T = next((P, T) for P, T in self.model.prefill_variants if len(seq_ids) <= P)
        fed: Dict[int, List[int]] = {}
        for idx in seq_ids:
            slot = self.slots[idx]
            task = slot.task
            n = min(T, len(task.prefill_tokens) - slot.pad())
            fed[idx] = [slot.next_input] + task.prefill_tokens[:n - 1]
            task.prefill_tokens = task.prefill_tokens[n - 1:]
            slot.next_input = task.prefill_tokens.pop(0)
            slot.prefilled_tokens.extend(fed[idx])
        # pad rows point at distinct idle slots: slot_idx must be unique, and a
        # row of length 0 leaves its slot bit-unchanged
        spare = (i for i in range(self.batch_size) if i not in fed)
        slot_idx = np.array(list(fed) + [next(spare) for _ in range(P - len(fed))], np.int32)
        tokens = np.zeros((P, T), np.int32)
        lengths = np.zeros((P,), np.int32)
        for row, chunk in enumerate(fed.values()):
            tokens[row, :len(chunk)] = chunk
            lengths[row] = len(chunk)
        self.carry = self.model.prefill_step_compact(self.carry, tokens, lengths, slot_idx)
        self.chunks_run += 1
        return len(fed)

    def _process_pending(self):
        """Read the previous dispatch's sampled tokens (the one host read of a
        block) and stream them to their requests."""
        pending, self._pending = self._pending, None
        if pending is None:
            return
        if pending.votes is not None:
            self._count_votes(pending.votes)
        sampled_np = pending.sampled.cpu().numpy()
        if sampled_np.ndim == 1:
            sampled_np = sampled_np[None, :]
        for idx, task_id in pending.decode_slots:
            slot = self.slots[idx]
            task = slot.task
            if task is None or task.task_id != task_id or task.is_finished():
                continue  # slot was reset/aborted while the step was in flight
            emitted: List[Tuple[int, str]] = []
            t_first = time.time()
            for k in range(sampled_np.shape[0]):
                new_token = int(sampled_np[k, idx])
                if new_token < 0:
                    continue  # slot was still prefilling at step k of the block
                if new_token in task.stop_tokens:
                    task.request_status = RequestStatus.FINISHED_STOPPED
                    break
                new_text = slot.decoder.push(new_token)
                task.timing.setdefault("first_token", t_first)
                task.generated_tokens.append(new_token)
                task.decoded_texts.append(new_text)
                if task.return_logits and pending.raw_logits is not None:
                    logits_row = pending.raw_logits[idx].to(torch.float32).cpu().numpy()
                    task.output_queue.put_nowait(
                        ("token_generated", (new_token, new_text, logits_row)))
                else:
                    emitted.append((new_token, new_text))
                if task.max_tokens is not None \
                        and len(task.generated_tokens) >= task.max_tokens:
                    task.request_status = RequestStatus.FINISHED_LENGTH_CAPPED
                    break
            if emitted:
                # one bridge event per slot per block (the interface fans it out)
                task.output_queue.put_nowait(("tokens_generated", emitted))

    def _count_votes(self, votes) -> None:
        """Lockstep: every host's vote sums, summed over the hosts (one gloo
        all-reduce a loop; it raises when a peer has died or within the
        group's timeout). A shutdown vote on any host stops this one after
        this loop, as every other."""
        counts = votes.cpu().numpy().astype(np.int64)
        if self.vote is not None:
            t0 = time.perf_counter()
            counts = self.vote.all_reduce(counts)
            self.vote_seconds += time.perf_counter() - t0
            self.vote_loops += 1
        self.vote_counts = counts
        if counts[0] > 0:
            self.shutdown_flag = True

    # ------------------------------------------------------------------- loop

    def _run_prefill_chunks(self, n_seq: int, decode_count: int) -> int:
        """One prefill chunk per `ratio` decode steps: a block of K steps owes
        K / ratio chunks. While prompts waiting for prefill (in flight,
        deferred or queued) outnumber the decoding slots and half the batch
        is empty, the ratio halves, so a cold burst of prompts is ingested
        faster. Returns the slots fed."""
        ratio = self.decode_prefill_ratio
        backlog = n_seq + len(self._deferred_tasks) + self.task_queue.qsize()
        idle = sum(1 for s in self.slots if s.phase == SlotPhase.EMPTY)
        if decode_count < backlog and idle >= self.batch_size // 2:
            ratio = max(1, ratio // 2)
        if n_seq == 0:
            # no debt while nothing prefills: it would fire a burst of chunks later
            self._seq_countdown = max(self._seq_countdown, 0)
        seq_count = 0
        while self._seq_countdown < 1 and n_seq > 0:
            fed = self._run_prefill_step()
            seq_count += fed
            self._seq_countdown += max(1, ratio)
            if fed == 0:
                break
        return seq_count

    def run_once(self) -> bool:
        """One scheduler iteration; returns True if any forward work was done."""
        loop_start = time.perf_counter()
        self.loop_count += 1
        self._emit_ready_snapshots()  # last loop's host copies are done
        finished: List[int] = []
        for idx, slot in enumerate(self.slots):
            if slot.phase == SlotPhase.EMPTY:
                continue
            if self._is_aborted(slot.task):
                slot.task.request_status = RequestStatus.FINISHED_ABORTED
            if slot.task.is_finished():
                finished.append(idx)
        for idx in finished:
            self._finish_slot(idx)

        self._fill_slots()
        self._check_seq_transitions()
        self._flush_snapshot_batch()  # SEQ_PREFILL boundaries, before any dispatch
        n_active = sum(1 for s in self.slots if s.phase in _STEPPED)
        n_seq = sum(1 for s in self.slots if s.phase == SlotPhase.SEQ_PREFILL)
        if n_active == 0 and n_seq == 0 and not self.lockstep:
            self._process_pending()  # drain the last in-flight step before idling
            return False
        decode_count = one_prefill_count = seq_count = 0
        if n_active > 0 or self.lockstep:
            # lockstep dispatches the block (all-inactive when idle): its
            # read carries the vote
            K = self._choose_block_size()
            if K > 1 or self.lockstep:
                total, decode_count = self._dispatch_decode_block(K)
            else:
                total, decode_count = self._dispatch_decode_step()
            one_prefill_count = total - decode_count
            self.steps_run += K
            self._seq_countdown -= K
            self._flush_snapshot_batch()  # the block's boundaries, before a chunk
        else:
            self._seq_countdown = 0
        if self.lockstep:
            # at most one chunk a loop, when the countdown is due
            if self._seq_countdown < 1:
                if n_seq > 0:
                    seq_count = self._run_prefill_step()
                self._seq_countdown = max(1, self.decode_prefill_ratio)
        else:
            seq_count = self._run_prefill_chunks(n_seq, decode_count)
        # read the PREVIOUS dispatch's tokens while this one runs on the device
        self._process_pending()
        self._loop_times.append(time.perf_counter() - loop_start)
        self._emit_worker_event("worker_performance", {
            "avg_loop_time": sum(self._loop_times) / len(self._loop_times),
            "state_size": self.batch_size,
            "task_details": {"decode_count": decode_count,
                             "one_prefill_count": one_prefill_count,
                             "seq_prefill_count": seq_count},
            "loop_count": self.loop_count,
            "snapshot_skips": self.snapshot_skips,
            "snapshot_evictions": self.snapshot_evictions,
            "state_pool_free_rows": (self.pool_allocator.available()
                                     if self.state_pool is not None else None),
            "max_allocated_memory_GB": self._device_memory_gb(),
            "vote_us": (round(1e6 * self.vote_seconds / self.vote_loops, 1)
                        if self.vote_loops else None),
        })
        # lockstep: every host idles at the same loop, when no host has a task
        return not (self.lockstep and self.vote_counts[1] == 0)

    def _device_memory_gb(self) -> Optional[float]:
        if self.model.device.type != "cuda":
            return None
        return round(torch.cuda.max_memory_allocated(self.model.device) / 2 ** 30, 3)

    def start(self):
        try:
            if self.model is None:
                self._init_worker()
            if self.warmup_programs:
                # the success handshake only after the warm-up: a failure
                # there (a capture that fails, memory) reaches the engine
                self._warmup_programs()
            self._emit_worker_event("worker_loaded", {
                "status": "success", "worker_id": self.worker_id,
                "batch_size": self.batch_size})
        except Exception as exc:  # noqa: BLE001 — reported through the handshake
            traceback.print_exc()
            self._emit_worker_event("worker_loaded", {
                "status": "error", "worker_id": self.worker_id, "error": str(exc)})
            return
        while True:
            if self._process_master_events() or self.shutdown_flag:
                break
            try:
                did_work = self.run_once()
            except Exception as exc:  # noqa: BLE001
                # a failing worker fails its tasks loudly instead of stranding them
                traceback.print_exc()
                self._emit_worker_event("worker_error", {"error": str(exc)})
                self._abort_all_tasks()
                if self.lockstep:
                    break  # out of step with the other hosts for good
                time.sleep(0.5)
                continue
            if self.shutdown_flag:
                # lockstep quorum: every host stops after this loop
                print(f"[{self.worker_id}] lockstep shutdown after loop {self.loop_count}",
                      flush=True)
                self._abort_all_tasks()
                break
            if not did_work:
                time.sleep(self.idle_sleep)
        self._cleanup()

    def _abort_all_tasks(self):
        for idx, slot in enumerate(self.slots):
            if slot.task is not None:
                slot.task.request_status = RequestStatus.FINISHED_ABORTED
                slot.task.output_queue.put_nowait(("task_completed", slot.task))
                self.slots[idx] = SlotData()
        for task in self._deferred_tasks:
            self._fail(task)
        self._deferred_tasks = []
        self._pending = None
        for _, row in self._snapshot_batch:
            self.pool_allocator.free(row)
        self._snapshot_batch = []
        self._pending_snapshots = []

    def _cleanup(self):
        """Drop the carry and the model; under tp the model's close() stops
        the other ranks and leaves the group (from this thread, which made
        every call). Under lockstep, leave the vote group."""
        if self.vote is not None:
            self.vote.close()
        self.carry = None
        close = getattr(self.model, "close", None)
        if close is not None:
            close()
        self.model = None


def start_worker_thread(worker: Worker) -> threading.Thread:
    t = threading.Thread(target=worker.start, daemon=True,
                         name=f"chirrup_tpu_torch:{worker.worker_id}")
    t.start()
    return t
