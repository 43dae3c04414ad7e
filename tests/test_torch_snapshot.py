"""Slot snapshots of chirrup_tpu_torch's ServingModel (extract_slot,
insert_slot) against the JAX package's, on the CPU.

A snapshot keeps the state at its device dtype, bf16 in serving, as the JAX
package's does: the same host bytes, and a resume that is bit-identical to a
run that was never interrupted. insert_slot also takes float32 numpy arrays
and the JAX package's ml_dtypes bfloat16 arrays.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
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

CFG = dict(n_layer=2, n_embd=128, vocab_size=512, d_decay_lora=32, d_iclr_lora=32,
           d_v_lora=16, d_gate_lora=32)
B = 4


class _Task:
    temperature, top_p, top_k = 0.0, 0.3, 0
    frequency_penalty, presence_penalty, penalty_decay = 0.0, 0.0, 1.0
    forbidden_tokens = ()


@pytest.fixture(scope="module")
def dense():
    return jax.tree_util.tree_map(np.asarray, j_synthetic_params(JConfig(**CFG), seed=8))


def _port(dense, dtype=torch.bfloat16, quantization="int8"):
    rt = RuntimeConfig(activation_dtype=dtype, wkv_state_dtype=dtype,
                       quantization=quantization)
    return ServingModel(RWKV7Config(**CFG), params_from_numpy(dense, device="cpu"), rt,
                        batch_size=B, device="cpu")


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


def test_snapshot_bytes_equal_jax(dense):
    """The port's snapshot of a bf16 serving state takes the JAX snapshot's
    host bytes (nbytes): bf16 CPU tensors of the same shapes, not float32."""
    jrt = JRuntime(activation_dtype=jnp.bfloat16, wkv_state_dtype=jnp.bfloat16,
                   quantization="int8", use_pallas_wkv=True)
    jm = JServing(JConfig(**CFG), jax.tree_util.tree_map(jnp.asarray, dense), jrt,
                  batch_size=B, interpret_pallas=True)
    js = jm.extract_slot(jm.init_carry(), 1)
    tm = _port(dense)
    ts = tm.extract_slot(tm.init_carry(), 1)
    assert ts.shift.dtype == ts.wkv.dtype == torch.bfloat16
    assert tuple(ts.shift.shape) == js.shift.shape and tuple(ts.wkv.shape) == js.wkv.shape
    assert ts.nbytes() == js.nbytes()
    f32 = _port(dense, torch.float32)
    assert f32.extract_slot(f32.init_carry(), 1).nbytes() == 2 * ts.nbytes() - 8


@pytest.mark.parametrize("quantization", ["int8", None])
def test_resume_from_snapshot_is_bit_identical(dense, quantization):
    """Extract slot 1 of a bf16 carry that has run a few steps, insert the
    snapshot into slot 3, and feed both slots the same token: the next decode
    step's raw logits and the state of both slots are bit-identical, and the
    snapshot shares no memory with the carry."""
    m = _port(dense, quantization=quantization)
    c = _advance(m)
    snap = m.extract_slot(c, 1)
    m.insert_slot(c, 3, snap, _Task())
    st = c.state
    assert torch.equal(st.shift[:, :, 3], st.shift[:, :, 1])
    assert torch.equal(st.wkv[:, 3], st.wkv[:, 1]) and st.elapsed[3] == st.elapsed[1]
    on = np.ones(B, bool)
    _, _, raw = m.decode_step(c, np.array([5, 9, 11, 9], np.int32), on, on)
    assert torch.equal(raw[1], raw[3])
    assert torch.equal(st.shift[:, :, 3], st.shift[:, :, 1])
    assert torch.equal(st.wkv[:, 3], st.wkv[:, 1]) and st.elapsed[3] == st.elapsed[1]
    assert not torch.equal(snap.wkv, st.wkv[:, 1])  # the carry moved on, the copy did not


def test_insert_takes_numpy_and_jax_snapshots(dense):
    """insert_slot takes the port's snapshot, float32 numpy arrays (rounded
    to the state's dtype) and the JAX package's snapshot of ml_dtypes
    bfloat16 arrays (recognised by their dtype's name, exact)."""
    m = _port(dense)
    c = _advance(m)
    snap = m.extract_slot(c, 2)
    shift32, wkv32 = snap.shift.float().numpy(), snap.wkv.float().numpy()
    jax_snap = JRequestState(shift=shift32.astype(ml_dtypes.bfloat16),
                             wkv=wkv32.astype(ml_dtypes.bfloat16), elapsed=snap.elapsed)
    rng = np.random.default_rng(3)
    noisy = RequestState(shift=shift32 + rng.standard_normal(shift32.shape).astype(np.float32),
                         wkv=wkv32, elapsed=7)
    for s, state in ((0, snap), (1, jax_snap)):
        m.insert_slot(c, s, state, _Task())
        assert torch.equal(c.state.shift[:, :, s], snap.shift)
        assert torch.equal(c.state.wkv[:, s], snap.wkv)
        assert int(c.state.elapsed[s]) == snap.elapsed
    m.insert_slot(c, 3, noisy, _Task())
    assert torch.equal(c.state.shift[:, :, 3], torch.from_numpy(noisy.shift).to(torch.bfloat16))
    assert int(c.state.elapsed[3]) == 7
