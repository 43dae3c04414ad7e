"""Prefix snapshots and resumes through chirrup_tpu_torch's AsyncEngineCore
on the CPU: the counterparts of tests/test_engine.py's cache_prefill and
resume cases, the pool and host resumes of tests/test_state_pool.py, the
port engine against the JAX engine on the same cache hit, and a batch-4
soak with cache_prefill (tests/test_scheduler_soak.py).

Greedy generation resumed from a snapshot equals the uncached run token for
token: the snapshot holds the state where cache_prefill_padding - 1 prompt
tokens are left, and both runs feed those tokens the same way.
"""

import asyncio
import random

import numpy as np
import pytest
import torch

from chirrup_tpu.engine.engine import AsyncEngineCore as JEngine
from chirrup_tpu.engine.structures import PoolHandle as JPoolHandle
from chirrup_tpu_torch.engine.engine import AsyncEngineCore
from chirrup_tpu_torch.engine.state_cache import PrefixStateCache
from chirrup_tpu_torch.engine.structures import (ModelLoadConfig, PoolHandle, RequestState,
                                                 RequestStatus)
from chirrup_tpu_torch.engine.worker import SlotPhase, Worker

from tests.engine_fixtures import VOCAB_SIZE, synthetic_model_config, write_tiny_vocab

PROMPT = "hello world the Assistant says hello world again and again ok"
GREEDY = dict(temperature=0.0, stop_tokens=[0], presence_penalty=0.0, frequency_penalty=0.0)


@pytest.fixture(scope="module")
def vocab_path(tmp_path_factory):
    return write_tiny_vocab(str(tmp_path_factory.mktemp("vocab") / "vocab.txt"))


def _config(vocab_path, **kw):
    """The JAX engine fixture's model (tests/engine_fixtures.py), in the port:
    float32, prefill chunks of 8 tokens."""
    return ModelLoadConfig(
        model_path="<synthetic>", vocab_path=vocab_path, vocab_size=VOCAB_SIZE,
        quantization=None, wkv_state_dtype="float32", activation_dtype="float32",
        prefill_chunk=8, synthetic_config=dict(n_layer=2, n_embd=128, vocab_size=VOCAB_SIZE,
                                               d_decay_lora=32, d_iclr_lora=32, d_v_lora=16,
                                               d_gate_lora=32), **kw)


async def _engine(vocab_path, batch_size=4, **kw):
    eng = AsyncEngineCore()
    await eng.init(worker_num=kw.pop("worker_num", 1), model_config=_config(vocab_path),
                   batch_size=batch_size, load_timeout=60, device="cpu", **kw)
    return eng


async def _run(eng, prompt, **kw):
    """(tokens, the cache_prefill event's payload or None, the task)."""
    comp = eng.completion(prompt, **{**GREEDY, **kw})
    toks, snap = [], None
    async for ev in comp:
        if ev[0] == "token":
            toks.append(ev[1])
        elif ev[0] == "cache_prefill":
            snap = ev[1]
    return toks, snap, comp.task


def _stop(eng):
    eng.shutdown()
    eng.join(timeout=10)


def _resume_round_trip(vocab_path, pad, state_pool_size=0, K=None, n=4):
    """An uncached greedy run of PROMPT with cache_prefill at `pad`, then a
    run resumed from its snapshot with the prompt's rest: (ids, the first
    run's tokens, its snapshot event, the resumed run's tokens and task,
    the worker)."""

    async def go():
        eng = await _engine(vocab_path, state_pool_size=state_pool_size,
                            decode_block_size=K)
        try:
            ids = eng.tokenizer.encode(PROMPT)
            toks1, snap, _ = await _run(eng, PROMPT, prefill_tokens=list(ids), max_tokens=n,
                                        cache_prefill=True, cache_prefill_padding=pad)
            assert snap is not None and snap["state"] is not None
            cut = len(snap["prefilled_tokens"])
            toks2, _, task2 = await _run(eng, PROMPT, prefill_tokens=list(ids[cut:]),
                                         state=snap["state"], max_tokens=n)
            return ids, toks1, snap, toks2, task2, eng.workers[0]
        finally:
            _stop(eng)

    return asyncio.run(asyncio.wait_for(go(), 120))


def test_cache_prefill_event(vocab_path):
    """Counterpart of tests/test_engine.py:160: the host snapshot (state
    pool off) holds the prompt less its last 3 tokens, at the state's
    dtype and shapes, elapsed at that length."""

    async def go():
        eng = await _engine(vocab_path)
        try:
            ids = eng.tokenizer.encode(PROMPT)
            _, snap, _ = await _run(eng, PROMPT, prefill_tokens=list(ids), max_tokens=3,
                                    cache_prefill=True, cache_prefill_padding=3)
            return ids, snap
        finally:
            _stop(eng)

    ids, snap = asyncio.run(asyncio.wait_for(go(), 120))
    assert list(snap["prefilled_tokens"]) == ids[:-3]
    st = snap["state"]
    assert isinstance(st, RequestState)
    assert tuple(st.shift.shape) == (2, 2, 128) and tuple(st.wkv.shape) == (2, 64, 128)
    assert st.wkv.dtype == torch.float32 and st.elapsed == len(ids) - 3
    assert bool(torch.isfinite(st.wkv).all()) and st.wkv.abs().max() > 0


@pytest.mark.parametrize("K", [1, 4])
def test_resume_from_state(vocab_path, K):
    """Counterpart of tests/test_engine.py:186 (host snapshot, state pool
    off): the resumed run gives the uncached run's greedy tokens, with
    single steps and with 4-step blocks (the slot pauses at its boundary
    inside a block)."""
    ids, toks1, snap, toks2, task2, _ = _resume_round_trip(vocab_path, 3, K=K)
    assert isinstance(snap["state"], RequestState)
    assert len(toks1) >= 1 and toks2 == toks1
    assert task2.is_finished()


@pytest.mark.parametrize("K", [1, 4])
def test_resume_from_pool_handle(vocab_path, K):
    """Counterpart of tests/test_state_pool.py:123: the snapshot is a row of
    the worker's state pool; the resumed run gives the uncached run's
    greedy tokens, and the worker releases the handle's reference after
    loading the row (0 refs, its row free again)."""
    ids, toks1, snap, toks2, _, worker = _resume_round_trip(vocab_path, 3,
                                                            state_pool_size=2, K=K)
    handle = snap["state"]
    assert isinstance(handle, PoolHandle) and handle.worker_id == worker.worker_id
    assert handle.device_bytes == (2 * 2 * 128 + 2 * 64 * 128) * 4 + 4
    assert list(snap["prefilled_tokens"]) == ids[:-3]
    assert len(toks1) >= 1 and toks2 == toks1
    assert handle.refs == 0 and not handle.revoked
    assert worker.pool_allocator.available() == worker.pool_allocator.size == 6


@pytest.mark.parametrize("pad", [0, 12])
def test_cache_prefill_large_padding(vocab_path, pad):
    """Counterpart of tests/test_engine.py:306 and the two paddings the JAX
    worker's comments record as crashes: 12 (at least min_forward_seq_len,
    which used to strand the slot in SEQ_PREFILL) and 0 (the boundary is the
    prompt's end: the slot must go to DECODE, its last token the first
    decode input). Generation goes on and the snapshot holds the prompt less
    max(padding, 1) tokens."""
    ids, toks1, snap, toks2, _, _ = _resume_round_trip(vocab_path, pad, n=3)
    assert len(ids) > 14 and len(toks1) >= 1
    assert list(snap["prefilled_tokens"]) == ids[:-max(pad, 1)]
    assert snap["state"].elapsed == len(ids) - max(pad, 1)
    assert toks2 == toks1


def test_state_needs_prefill_tokens(vocab_path):
    async def go():
        eng = await _engine(vocab_path, batch_size=1)
        try:
            with pytest.raises(ValueError, match="prefill_tokens"):
                eng.completion(PROMPT, state=RequestState(torch.zeros(1), torch.zeros(1), 0))
        finally:
            _stop(eng)

    asyncio.run(asyncio.wait_for(go(), 60))


def test_state_pool_rows_and_single_worker_rule(vocab_path, capsys):
    """init(state_pool_size=n) gives the one worker n + 4 rows; with two
    workers the pool is off (a notice, host snapshots), as in the JAX
    engine."""

    async def go():
        one = await _engine(vocab_path, batch_size=2, state_pool_size=3)
        try:
            w = one.workers[0]
            rows = (w.pool_allocator.size, w.state_pool["wkv"].shape[0])
        finally:
            _stop(one)
        two = await _engine(vocab_path, batch_size=2, state_pool_size=3, worker_num=2)
        try:
            pools = [w.state_pool for w in two.workers]
            _, snap, _ = await _run(two, PROMPT, max_tokens=2, cache_prefill=True,
                                    cache_prefill_padding=2)
        finally:
            _stop(two)
        return rows, pools, snap

    rows, pools, snap = asyncio.run(asyncio.wait_for(go(), 120))
    assert rows == (7, 7)
    assert pools == [None, None] and isinstance(snap["state"], RequestState)
    assert "state pool disabled" in capsys.readouterr().out


def test_foreign_pool_handle_fails_its_task(vocab_path):
    """A PoolHandle of another worker (or one given while the pool is off)
    cannot be resumed: the task ends aborted with a completion event, and
    the reference it carried is released."""
    from chirrup_tpu_torch.engine.structures import StatePoolAllocator

    async def go():
        eng = await _engine(vocab_path, batch_size=2, state_pool_size=1)
        try:
            other = StatePoolAllocator(1)
            handle = PoolHandle(row=other.alloc(), worker_id="worker_9", allocator=other)
            toks, _, task = await _run(eng, PROMPT, prefill_tokens=[5, 6], state=handle,
                                       max_tokens=2)
            return toks, task, handle, other
        finally:
            _stop(eng)

    toks, task, handle, other = asyncio.run(asyncio.wait_for(go(), 60))
    assert toks == [] and task.request_status == RequestStatus.FINISHED_ABORTED
    assert handle.refs == 0 and other.available() == 1


def test_cache_hit_matches_jax_engine(vocab_path):
    """The JAX engine (its fixture model, state pool on) and the port's
    engine on the same weights: a cache_prefill run of a long prompt
    (chunked prefill, snapshot, token-by-token tail) and a run resumed from
    its PoolHandle give the same greedy tokens in both, and the same
    snapshot key."""
    import jax
    from chirrup_tpu.models.config import RWKV7Config as JConfig
    from chirrup_tpu.models.loader import synthetic_params as j_synthetic_params
    from chirrup_tpu_torch.engine.serving import ServingModel
    from chirrup_tpu_torch.models.config import RWKV7Config, RuntimeConfig
    from chirrup_tpu_torch.models.loader import params_from_numpy
    from chirrup_tpu_torch.utils.tokenizer import WorldTokenizer

    cfg = _config(vocab_path)

    async def hit(eng, handle_type):
        ids = eng.tokenizer.encode(PROMPT)
        toks1, snap, _ = await _run(eng, PROMPT, prefill_tokens=list(ids), max_tokens=5,
                                    cache_prefill=True, cache_prefill_padding=3)
        assert isinstance(snap["state"], handle_type)
        toks2, _, _ = await _run(eng, PROMPT, prefill_tokens=list(ids[-3:]),
                                 state=snap["state"], max_tokens=5)
        return toks1, toks2, tuple(snap["prefilled_tokens"])

    async def run_jax():
        eng = JEngine()
        await eng.init(worker_num=1, model_config=synthetic_model_config(vocab_path),
                       batch_size=4, load_timeout=120, state_pool_size=2)
        try:
            return await hit(eng, JPoolHandle)
        finally:
            eng.shutdown()
            eng.join(timeout=10)

    def factory():
        dense = jax.tree_util.tree_map(
            np.asarray, j_synthetic_params(JConfig(**cfg.synthetic_config), seed=0))
        rt = RuntimeConfig(activation_dtype=torch.float32, wkv_state_dtype=torch.float32)
        model = ServingModel(RWKV7Config(**cfg.synthetic_config),
                             params_from_numpy(dense, device="cpu"), rt, 4, prefill_chunk=8,
                             device="cpu")
        return model, WorldTokenizer(vocab_path)

    async def run_port():
        eng = AsyncEngineCore()
        await eng.init(worker_num=1, model_config=cfg, batch_size=4, load_timeout=60,
                       model_factory=factory, device="cpu", state_pool_size=2)
        try:
            assert len(eng.tokenizer.encode(PROMPT)) - 1 - 2 >= Worker.min_forward_seq_len
            return await hit(eng, PoolHandle)
        finally:
            _stop(eng)

    want = asyncio.run(asyncio.wait_for(run_jax(), 180))
    got = asyncio.run(asyncio.wait_for(run_port(), 60))
    assert len(want[0]) >= 1 and want[1] == want[0]
    assert got == want


WORDS = ["hello", "world", "the", "User", "Assistant", "ok", "maybe", "again", "and", "so"]


@pytest.mark.parametrize("state_pool_size", [0, 2])
def test_cache_prefill_soak(vocab_path, state_pool_size):
    """Counterpart of tests/test_scheduler_soak.py:30 at batch 4, with
    cache_prefill on 30% of the requests at paddings {0, 3, 7, 12}, through
    a PrefixStateCache as a server would use it: each request resumes from
    the longest cached prefix it finds (a pool handle acquired for it),
    and each snapshot is cached under the resumed prefix plus the tokens
    fed. Random sampling parameters, stop and forbidden sets, and aborts.
    Prompts repeat (six drawn once), so later requests find cached
    prefixes. Every request ends within its limits; afterwards every slot is EMPTY,
    nothing is queued, and once the cache is emptied every handle is
    released and every pool row free."""
    rng = random.Random(20260818)
    prompts = [" ".join(rng.choice(WORDS) for _ in range(rng.randint(5, 30)))
               for _ in range(6)]

    async def go():
        eng = await _engine(vocab_path, state_pool_size=state_pool_size,
                            decode_block_size=rng.choice([1, 4]))
        cache = PrefixStateCache(max_size=3)
        handles = []

        async def one(i):
            prompt = rng.choice(prompts)
            stop = rng.choice([[0], [0, 261], list(range(0, 50))])
            forbidden = rng.choice([(), tuple(rng.sample(range(1, 300), 5)),
                                    tuple(range(100, 140))])
            max_tokens = rng.randint(1, 12)
            abort_after = rng.choice([None, None, None, 1, 3])
            ids = eng.tokenizer.encode(prompt)
            remaining, state, cached = cache.check(ids)
            if isinstance(state, PoolHandle) and not state.try_acquire():
                remaining, state, cached = ids, None, 0
            comp = eng.completion(
                prompt, prefill_tokens=list(remaining), state=state,
                temperature=rng.choice([0.0, 0.7, 1.0]), top_p=rng.choice([0.2, 0.8, 1.0]),
                top_k=rng.choice([0, 3]), max_tokens=max_tokens, stop_tokens=stop,
                forbidden_tokens=forbidden, presence_penalty=rng.choice([0.0, 0.4]),
                frequency_penalty=rng.choice([0.0, 0.4]), cache_prefill=rng.random() < 0.3,
                cache_prefill_padding=rng.choice([0, 3, 7, 12]))
            toks = []
            async for ev in comp:
                if ev[0] == "token":
                    toks.append(ev[1])
                    if abort_after is not None and len(toks) >= abort_after:
                        comp.abort()
                elif ev[0] == "cache_prefill" and ev[1]["state"] is not None:
                    snap = ev[1]["state"]
                    handles.append(snap)
                    cache.cache(tuple(ids[:cached]) + tuple(ev[1]["prefilled_tokens"]), snap)
            task = comp.task
            assert task.is_finished(), i
            assert len(toks) <= max_tokens, (i, toks)
            assert not (set(toks) & set(stop)), (i, toks, stop)
            assert not (set(toks) & set(forbidden)), (i, toks, forbidden)
            return cached

        try:
            resumed = []
            for _ in range(3):
                resumed += await asyncio.gather(*[one(i) for i in range(8)])
            await asyncio.sleep(0.3)
            worker = eng.workers[0]
            phases = [s.phase for s in worker.slots]
            queued = eng.task_queue.qsize()
            for key in list(cache._lru):
                cache.remove(key)
            return resumed, phases, queued, handles, worker
        finally:
            _stop(eng)

    resumed, phases, queued, handles, worker = asyncio.run(asyncio.wait_for(go(), 300))
    assert all(p == SlotPhase.EMPTY for p in phases) and queued == 0
    assert handles and any(resumed)
    if state_pool_size:
        assert all(isinstance(h, PoolHandle) and not h.alive for h in handles)
        alloc = worker.pool_allocator
        assert alloc.available() == alloc.size and len(alloc._evictable) == 0
    else:
        assert all(isinstance(h, RequestState) for h in handles)
