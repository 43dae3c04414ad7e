"""chirrup_tpu_torch's device state pool and host snapshots (engine/serving.py:
init_state_pool, pool_store_many, pool_load, extract_slot_async), against
the JAX package's pool (tests/test_state_pool.py) on the CPU.

A pool row has the JAX package's layout, shift (L, 2, C), wkv (L, N, H*N)
and elapsed, so a port row equals a JAX row element for element. Every pool
operation writes in place (a captured graph holds the carry's addresses);
the async host snapshot copies the slot's rows before it returns, so a
block dispatched after it cannot change what it gives.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chirrup_tpu.engine.serving import ServingModel as JServing
from chirrup_tpu.engine.structures import RequestState as JRequestState
from chirrup_tpu.models.config import RWKV7Config as JConfig
from chirrup_tpu.models.config import RuntimeConfig as JRuntime
from chirrup_tpu.models.loader import synthetic_params as j_synthetic_params
from chirrup_tpu_torch.engine.serving import ServingModel
from chirrup_tpu_torch.engine.structures import RequestState
from chirrup_tpu_torch.models.config import RWKV7Config, RuntimeConfig
from chirrup_tpu_torch.models.loader import params_from_numpy

CFG = dict(n_layer=2, n_embd=128, vocab_size=300, d_decay_lora=32, d_iclr_lora=32,
           d_v_lora=16, d_gate_lora=32)
B = 4
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


class _Task:
    temperature, top_p, top_k = 0.0, 0.3, 0
    frequency_penalty, presence_penalty, penalty_decay = 0.0, 0.0, 1.0
    forbidden_tokens = ()


@pytest.fixture(scope="module")
def dense():
    return jax.tree_util.tree_map(np.asarray, j_synthetic_params(JConfig(**CFG), seed=7))


def _port(dense, dtype=torch.float32):
    rt = RuntimeConfig(activation_dtype=dtype, wkv_state_dtype=dtype, quantization=None)
    return ServingModel(RWKV7Config(**CFG), params_from_numpy(dense, device="cpu"), rt,
                        batch_size=B, prefill_chunk=8, device="cpu")


def _advance(m, steps=3, seed=0):
    """A carry with every slot inserted and `steps` decode steps fed."""
    c = m.init_carry()
    for s in range(B):
        m.insert_slot(c, s, None, _Task())
    rng = np.random.default_rng(seed)
    on = np.ones(B, bool)
    for _ in range(steps):
        m.decode_step(c, rng.integers(1, CFG["vocab_size"], B).astype(np.int32), on, on)
    return c


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_pool_store_load_roundtrip_bitexact(dense, dtype):
    """Counterpart of tests/test_state_pool.py:36: slot 1 -> row 2 -> slot 3
    equals the host snapshot of slot 1 bit for bit, in place."""
    m = _port(dense, DTYPES[dtype][0])
    carry = _advance(m)
    pool = m.init_state_pool(3)
    ptrs = [t.data_ptr() for t in (carry.state.shift, carry.state.wkv, carry.state.elapsed,
                                   pool["shift"], pool["wkv"], pool["elapsed"])]
    ref = m.extract_slot(carry, 1)
    assert m.pool_store(carry, pool, 1, 2) is pool
    assert m.pool_load(carry, pool, 2, 3) is carry
    got = m.extract_slot(carry, 3)
    assert torch.equal(ref.shift, got.shift) and torch.equal(ref.wkv, got.wkv)
    assert ref.elapsed == got.elapsed == 3
    assert torch.equal(pool["shift"][2], ref.shift) and int(pool["elapsed"][2]) == 3
    assert not pool["wkv"][:2].any() and not pool["elapsed"][:2].any()
    assert ptrs == [t.data_ptr() for t in (carry.state.shift, carry.state.wkv,
                                           carry.state.elapsed, pool["shift"], pool["wkv"],
                                           pool["elapsed"])]


def test_pool_store_many_any_count(dense):
    """pool_store_many takes any number of pairs (the JAX package chains fixed
    programs of 8): ten snapshots of four slots into ten rows."""
    m = _port(dense)
    carry = _advance(m, steps=2, seed=1)
    pool = m.init_state_pool(10)
    pairs = [(i % B, 9 - i) for i in range(10)]
    m.pool_store_many(carry, pool, pairs)
    for slot, row in pairs:
        assert torch.equal(pool["shift"][row], carry.state.shift[:, :, slot])
        assert torch.equal(pool["wkv"][row], carry.state.wkv[:, slot])
        assert int(pool["elapsed"][row]) == int(carry.state.elapsed[slot])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_pool_row_equals_jax_pool_row(dense, dtype):
    """The same state (random, from a seed) inserted into slot 2 of both
    packages' carries and stored into row 1: the port's row equals the JAX
    package's row element for element (bf16 compared exactly through
    float32), shift, wkv and elapsed, and pool_row_bytes agree."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(11)
    L, C, N = CFG["n_layer"], CFG["n_embd"], 64
    state = dict(shift=rng.standard_normal((L, 2, C)).astype(np.float32),
                 wkv=rng.standard_normal((L, N, C)).astype(np.float32), elapsed=37)
    jrt = JRuntime(activation_dtype=jdt, wkv_state_dtype=jdt, quantization=None,
                   use_pallas_wkv=False)
    jm = JServing(JConfig(**CFG), jax.tree_util.tree_map(jnp.asarray, dense), jrt,
                  batch_size=B)
    jc = jm.insert_slot(jm.init_carry(), 2, JRequestState(**state), _Task())
    jpool = jm.pool_store(jc, jm.init_state_pool(3), 2, 1)
    tm = _port(dense, tdt)
    tc = tm.insert_slot(tm.init_carry(), 2, RequestState(**state), _Task())
    tpool = tm.pool_store(tc, tm.init_state_pool(3), 2, 1)
    for k in ("shift", "wkv"):
        assert tpool[k].dtype == tdt
        np.testing.assert_array_equal(tpool[k].float().numpy(),
                                      np.asarray(jpool[k]).astype(np.float32), err_msg=k)
    np.testing.assert_array_equal(tpool["elapsed"].numpy(), np.asarray(jpool["elapsed"]))
    assert tm.pool_row_bytes() == jm.pool_row_bytes()


def test_pool_row_bytes_at_7b_width():
    """A row at g1 7.2B width (L 32, C 4096, N 64) in bf16: 524,288 bytes of
    shift, 16,777,216 of wkv and 4 of elapsed."""
    rt = RuntimeConfig(activation_dtype=torch.bfloat16, wkv_state_dtype=torch.bfloat16)
    fake = types.SimpleNamespace(config=RWKV7Config(n_layer=32, n_embd=4096, vocab_size=65536),
                                 runtime=rt)
    assert ServingModel.pool_row_bytes(fake) == 524_288 + 16_777_216 + 4 == 17_301_508


def test_async_snapshot_is_taken_at_the_call(dense):
    """extract_slot_async copies the slot's rows before it returns: a decode
    block dispatched after it advances the slot, and the snapshot it gives
    is still the state at the call, equal to extract_slot's then (a
    resolver that read the carry would give the later state)."""
    m = _port(dense, torch.bfloat16)
    carry = _advance(m, steps=2, seed=2)
    before = m.extract_slot(carry, 2)
    resolve = m.extract_slot_async(carry, 2)
    K = 3
    on = np.ones((K, B), bool)
    m.decode_block(carry, np.full((K, B), 7, np.int32), on, on, on)
    assert int(carry.state.elapsed[2]) == before.elapsed + K
    got = resolve()
    assert isinstance(got, RequestState) and got.elapsed == before.elapsed
    assert torch.equal(got.shift, before.shift) and torch.equal(got.wkv, before.wkv)
    assert not torch.equal(got.wkv, carry.state.wkv[:, 2])
    assert got.shift.is_contiguous() and got.wkv.dtype == torch.bfloat16


def test_insert_and_pool_load_resume_bit_identical(dense):
    """A pool resume (batched insert, then pool_load) and a host resume
    (insert_slot of the snapshot) give the same next-step logits as the
    slot they came from, bit for bit."""
    m = _port(dense, torch.bfloat16)
    carry = _advance(m, steps=3, seed=3)
    pool = m.init_state_pool(2)
    m.pool_store(carry, pool, 0, 1)
    snap = m.extract_slot(carry, 0)
    mask = np.array([False, False, True, False])
    m.insert_slots_batched(carry, mask, [None, None, _Task(), None])
    m.pool_load(carry, pool, 1, 2)
    m.insert_slot(carry, 3, snap, _Task())
    on = np.ones(B, bool)
    _, _, raw = m.decode_step(carry, np.array([9, 1, 9, 9], np.int32), on, on)
    assert torch.equal(raw[2], raw[0]) and torch.equal(raw[3], raw[0])


def test_warmup_with_state_pool_leaves_the_carry_as_it_was(dense):
    """With a state pool the worker's warm-up also stores slot 0 into row 0
    and loads it back, and runs the batched insert with an all-False mask:
    the carry stays exactly as init_carry made it."""
    from chirrup_tpu_torch.engine.worker import Worker

    model = _port(dense)
    worker = Worker("w", lambda: (model, None), None, None, None, batch_size=B,
                    decode_block_size=2, warmup_programs=True, state_pool_size=3)
    worker._init_worker()
    assert worker.pool_allocator.size == 3 and worker.state_pool["wkv"].shape[0] == 3
    fresh = model.init_carry()
    worker._warmup_programs()
    st, ref = worker.carry.state, fresh.state
    assert torch.equal(st.shift, ref.shift) and torch.equal(st.wkv, ref.wkv)
    assert torch.equal(st.elapsed, ref.elapsed)
    for k in ("occurrence", "presence_vec", "temperature", "top_p", "top_k",
              "frequency_penalty", "presence_penalty", "penalty_decay", "last_sampled"):
        assert torch.equal(getattr(worker.carry, k), getattr(fresh, k)), k
    assert ("insert",) in worker.carry.programs
    assert worker.pool_allocator.available() == 3
