"""chirrup_tpu_torch's batched admission (ServingModel.insert_slots_batched)
against per-slot inserts and against the JAX package's insert_slots_batched
(tests/test_insert_batched.py), on the CPU: one staged upload of every
masked slot's parameters and forbidden ids, then masked writes that leave
the carry bit-equal to the per-slot inserts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chirrup_tpu.engine.serving import ServingModel as JServing
from chirrup_tpu.models.config import RWKV7Config as JConfig
from chirrup_tpu.models.config import RuntimeConfig as JRuntime
from chirrup_tpu.models.loader import synthetic_params as j_synthetic_params
from chirrup_tpu_torch.engine.serving import ServingModel
from chirrup_tpu_torch.models.config import RWKV7Config, RuntimeConfig
from chirrup_tpu_torch.models.loader import params_from_numpy

CFG = dict(n_layer=2, n_embd=128, vocab_size=300, d_decay_lora=32, d_iclr_lora=32,
           d_v_lora=16, d_gate_lora=32)
B = 4
FIELDS = ("shift", "wkv", "elapsed", "occurrence", "presence_vec", "temperature", "top_p",
          "top_k", "frequency_penalty", "presence_penalty", "penalty_decay", "last_sampled")


class _Task:
    def __init__(self, temperature=0.7, top_p=0.4, top_k=5, frequency_penalty=0.3,
                 presence_penalty=0.2, penalty_decay=0.99, forbidden_tokens=(7, 8, 9)):
        self.temperature, self.top_p, self.top_k = temperature, top_p, top_k
        self.frequency_penalty, self.presence_penalty = frequency_penalty, presence_penalty
        self.penalty_decay, self.forbidden_tokens = penalty_decay, forbidden_tokens


TASKS = [None, _Task(), None,
         _Task(temperature=0.0, top_p=1.0, top_k=0, forbidden_tokens=(1, 299, 300, -4, 1))]


@pytest.fixture(scope="module")
def dense():
    return jax.tree_util.tree_map(np.asarray, j_synthetic_params(JConfig(**CFG), seed=1))


def _port(dense, dtype=torch.float32):
    rt = RuntimeConfig(activation_dtype=dtype, wkv_state_dtype=dtype, quantization=None)
    return ServingModel(RWKV7Config(**CFG), params_from_numpy(dense, device="cpu"), rt,
                        batch_size=B, device="cpu")


def _fields(carry):
    st = carry.state
    return {k: (getattr(st, k) if k in ("shift", "wkv", "elapsed") else getattr(carry, k))
            for k in FIELDS}


def _dirty(m):
    """A carry every row of which differs from an insert's values: every slot
    inserted with penalties and stepped twice."""
    c = m.init_carry()
    for s in range(B):
        m.insert_slot(c, s, None, _Task(temperature=1.0, presence_penalty=0.5,
                                        frequency_penalty=0.5, forbidden_tokens=(3,)))
    on = np.ones(B, bool)
    for tok in (5, 6):
        m.decode_step(c, np.full(B, tok, np.int32), on, on, on)
    return c


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_insert_equals_per_slot_inserts(dense, dtype):
    """Counterpart of tests/test_insert_batched.py:42: the batched insert of
    slots 1 and 3 leaves every carry tensor bit-equal to two insert_slot
    calls, and slots 0 and 2 keep every bit (out-of-range forbidden ids are
    ignored by both)."""
    m = _port(dense, dtype)
    batched, serial = _dirty(m), _dirty(m)
    untouched = {k: v.clone() for k, v in _fields(batched).items()}
    mask = np.array([t is not None for t in TASKS])
    m.insert_slots_batched(batched, mask, TASKS)
    for i, t in enumerate(TASKS):
        if t is not None:
            m.insert_slot(serial, i, None, t)
    a, b = _fields(batched), _fields(serial)
    for k in FIELDS:
        assert torch.equal(a[k], b[k]), k
        rows = (lambda t: t[:, :, [0, 2]]) if k == "shift" else (
            (lambda t: t[:, [0, 2]]) if k == "wkv" else (lambda t: t[[0, 2]]))
        assert torch.equal(rows(a[k]), rows(untouched[k])), k
    assert (batched.presence_vec[3] == 1e10).sum() == 2  # ids 1 and 299


def test_batched_insert_equals_jax(dense):
    """Every slot inserted in both packages with one task, then both
    packages' batched insert of the same mask and tasks: every carry tensor
    is equal exactly."""
    jrt = JRuntime(activation_dtype=jnp.float32, wkv_state_dtype=jnp.float32,
                   quantization=None, use_pallas_wkv=False)
    jm = JServing(JConfig(**CFG), jax.tree_util.tree_map(jnp.asarray, dense), jrt,
                  batch_size=B)
    jc = jm.init_carry()
    for s in range(B):
        jc = jm.insert_slot(jc, s, None, _Task(forbidden_tokens=(3,)))
    mask = np.array([t is not None for t in TASKS])
    jc = jm.insert_slots_batched(jc, mask, TASKS)
    m = _port(dense)
    tc = m.init_carry()
    for s in range(B):
        m.insert_slot(tc, s, None, _Task(forbidden_tokens=(3,)))
    m.insert_slots_batched(tc, mask, TASKS)
    jf = dict(shift=jc.state.shift, wkv=jc.state.wkv, elapsed=jc.state.elapsed,
              **{k: getattr(jc, k) for k in FIELDS[3:]})
    for k, v in _fields(tc).items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jf[k]), err_msg=k)


def test_all_false_mask_changes_nothing(dense):
    """The warm-up's call (an all-False mask) leaves every bit of a dirty
    carry as it was; on the CPU the program runs eagerly, uncaptured."""
    m = _port(dense)
    c = _dirty(m)
    before = {k: v.clone() for k, v in _fields(c).items()}
    m.insert_slots_batched(c, np.zeros(B, bool), [None] * B)
    for k, v in _fields(c).items():
        assert torch.equal(v, before[k]), k
    prog = c.programs[("insert",)]
    assert prog.graph is None


def test_malformed_task_raises_before_the_device(dense):
    """A parameter that is not a number raises on the host, before the
    upload: the carry is unchanged."""
    m = _port(dense)
    c = _dirty(m)
    before = {k: v.clone() for k, v in _fields(c).items()}
    with pytest.raises(ValueError):
        m.insert_slots_batched(c, np.array([True] + [False] * 3),
                               [_Task(temperature="hot"), None, None, None])
    for k, v in _fields(c).items():
        assert torch.equal(v, before[k]), k


def test_insert_program_is_captured_in_place(dense, monkeypatch):
    """With graphs on, the batched insert is a program captured at first use
    (a stand-in capture records it), and it writes every carry tensor in
    place: no data pointer changes."""
    from chirrup_tpu_torch.engine import serving

    m = _port(dense)
    captured = []
    monkeypatch.setattr(serving._Program, "capture",
                        lambda self, carry, pool, stream: captured.append(self))
    m.graphs, m._pool, m._capture_stream = True, None, None
    c = _dirty(m)
    ptrs = {k: v.data_ptr() for k, v in _fields(c).items()}
    m.insert_slots_batched(c, np.array([t is not None for t in TASKS]), TASKS)
    assert captured[-1] is c.programs[("insert",)]
    assert {k: v.data_ptr() for k, v in _fields(c).items()} == ptrs
    assert float(c.temperature[1]) == np.float32(0.7) and int(c.top_k[1]) == 5
