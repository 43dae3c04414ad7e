"""chirrup_tpu_torch's serving programs (engine/serving.py): the staged inputs,
the noise drawn ahead of each program, the launch counts a CUDA graph replays,
and the worker's warm-up.

On the CPU no graph is ever captured: the programs run their bodies eagerly
on the same staged inputs and noise that a replay reads on the card, so the
bodies are held here to the JAX ServingModel and to single decode steps, and
the graph bookkeeping to a stand-in graph object.
"""

import asyncio

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from chirrup_tpu.engine.serving import ServingModel as JServing
from chirrup_tpu.models.config import RWKV7Config as JConfig
from chirrup_tpu.models.config import RuntimeConfig as JRuntime
from chirrup_tpu.models.loader import synthetic_params as j_synthetic_params
from chirrup_tpu_torch.engine import serving
from chirrup_tpu_torch.engine.engine import AsyncEngineCore
from chirrup_tpu_torch.engine.serving import ServingModel
from chirrup_tpu_torch.engine.worker import Worker
from chirrup_tpu_torch.models.config import RWKV7Config, RuntimeConfig
from chirrup_tpu_torch.models.loader import params_from_numpy
from chirrup_tpu_torch.ops import _kernels

from tests.engine_fixtures import VOCAB_SIZE, write_tiny_vocab

LORA = dict(d_decay_lora=32, d_iclr_lora=32, d_v_lora=16, d_gate_lora=32)
CFG = dict(n_layer=2, n_embd=128, vocab_size=16384, **LORA)  # the JAX tail's smallest V
F32 = RuntimeConfig(activation_dtype=torch.float32, wkv_state_dtype=torch.float32)
B = 4


class _Task:
    def __init__(self, temperature=0.0, top_p=0.3, top_k=0, frequency_penalty=0.0,
                 presence_penalty=0.0, penalty_decay=1.0, forbidden_tokens=()):
        self.temperature, self.top_p, self.top_k = temperature, top_p, top_k
        self.frequency_penalty, self.presence_penalty = frequency_penalty, presence_penalty
        self.penalty_decay, self.forbidden_tokens = penalty_decay, forbidden_tokens


@pytest.fixture(scope="module")
def dense():
    return jax.tree_util.tree_map(np.asarray, j_synthetic_params(JConfig(**CFG), seed=5))


def _model(dense, batch=B, **kw):
    return ServingModel(RWKV7Config(**CFG), params_from_numpy(dense, device="cpu"), F32,
                        batch_size=batch, prefill_chunk=8, device="cpu", **kw)


def _carry_tensors(carry):
    st = carry.state
    return dict(shift=st.shift, wkv=st.wkv, elapsed=st.elapsed, occurrence=carry.occurrence,
                presence_vec=carry.presence_vec, temperature=carry.temperature,
                top_p=carry.top_p, top_k=carry.top_k,
                frequency_penalty=carry.frequency_penalty,
                presence_penalty=carry.presence_penalty, penalty_decay=carry.penalty_decay,
                last_sampled=carry.last_sampled)


def test_cpu_captures_no_graph(dense):
    """With device="cpu" no graph is built, whatever `graphs` says: every
    program of the carry runs its body eagerly and records no launches."""
    model = _model(dense, graphs=True)
    assert not model.graphs
    carry = model.insert_slot(model.init_carry(), 0, None, _Task())
    K = 2
    on = np.zeros((K, B), bool)
    on[:, 0] = True
    model.decode_block(carry, np.full((K, B), 5, np.int32), on, on, on)
    model.decode_step(carry, np.zeros(B, np.int32), on[0], on[0])
    (P, T), = model.prefill_variants
    model.prefill_step_compact(carry, np.ones((P, T), np.int32), np.zeros(P, np.int32),
                               np.arange(P, dtype=np.int32))
    assert set(carry.programs) == {("block", K), ("step",), ("compact", P, T)}
    assert all(p.graph is None and not p.launches for p in carry.programs.values())


def test_staging_puts_each_array_at_its_view():
    """The staged inputs share one int32 buffer, each starting on a 64-byte
    boundary; put() writes every host array (bool as 0/1) where its view
    reads it."""
    st = serving._Staging([(3, 5), (7,), (2, 2)], torch.device("cpu"))
    assert st.offsets == [0, 16, 32]
    a = np.arange(15).reshape(3, 5)
    b = np.array([True, False] * 3 + [True])
    c = np.array([[-1, 2], [3, -4]])
    st.put([a, b, c])
    va, vb, vc = st.views()
    assert va.dtype == torch.int32 and va.shape == (3, 5)
    np.testing.assert_array_equal(va.numpy(), a)
    np.testing.assert_array_equal(vb.numpy(), b.astype(np.int32))
    np.testing.assert_array_equal(vc.numpy(), c)
    st.put([a + 1, ~b, c * 2])
    np.testing.assert_array_equal(va.numpy(), a + 1)  # the views follow the buffer
    np.testing.assert_array_equal(vb.numpy(), (~b).astype(np.int32))


def test_replays_count_the_launches_captured():
    """A capture counts its wrappers' launches but launches nothing:
    record_launches keeps them in the capture's own tally, out of LAUNCHES,
    and each replay of the graph (here a stand-in object) adds them once. A
    run returns copies of the static outputs."""

    def body(carry):  # what the wrappers do while a graph is captured
        _kernels.count_launch("penalty_tail")
        _kernels.count_launch("sample_exact_rows")
        for _ in range(5):
            _kernels.count_launch("mm8_a8_gemm")
        return (torch.arange(3),)

    class StandInGraph:
        replays = 0

        def replay(self):
            self.replays += 1

    saved = dict(_kernels.LAUNCHES)
    try:
        _kernels.reset_launches()
        outputs, counts = _kernels.record_launches(lambda: body(None))
        assert counts == {"penalty_tail": 1, "sample_exact_rows": 1, "mm8_a8_gemm": 5}
        assert not any(_kernels.LAUNCHES.values())
        prog = serving._Program(serving._Staging([(1,)], torch.device("cpu")), body)
        prog.graph, prog.outputs, prog.launches = StandInGraph(), outputs, counts
        for _ in range(3):
            got = prog.run(None)
        assert prog.graph.replays == 3
        assert {k: n for k, n in _kernels.LAUNCHES.items() if n} == {
            "penalty_tail": 3, "sample_exact_rows": 3, "mm8_a8_gemm": 15}
        assert torch.equal(got[0], outputs[0]) and got[0] is not outputs[0]
    finally:
        _kernels.LAUNCHES.update(saved)


def test_capture_tally_is_its_own_threads():
    """While one thread captures, another thread's launches are real: they
    go to LAUNCHES as they happen, and none of them into the capture's
    tally (each worker captures on its own thread)."""
    import threading

    started, done = threading.Event(), threading.Event()

    def other_worker():
        started.wait()
        for _ in range(4):
            _kernels.count_launch("wkv7_step_fused")
        done.set()

    def body():
        _kernels.count_launch("penalty_tail")
        started.set()
        assert done.wait(10)
        _kernels.count_launch("penalty_tail")
        return ()

    saved = dict(_kernels.LAUNCHES)
    try:
        _kernels.reset_launches()
        t = threading.Thread(target=other_worker)
        t.start()
        _, counts = _kernels.record_launches(body)
        t.join()
        assert counts == {"penalty_tail": 2}
        assert {k: n for k, n in _kernels.LAUNCHES.items() if n} == {"wkv7_step_fused": 4}
        _kernels.count_launch("penalty_tail")  # the capture over: counted again
        assert _kernels.LAUNCHES["penalty_tail"] == 1
    finally:
        _kernels.LAUNCHES.update(saved)


def test_only_the_worker_programs_are_captured(dense, monkeypatch):
    """With graphs on, decode_block, decode_step and the compact prefill are
    captured at first use; decode_block with logit_rows and the full-batch
    prefill_step run through programs of their own that are never captured
    (a stand-in capture records which programs ask for one)."""
    model = _model(dense)
    captured = []
    monkeypatch.setattr(serving._Program, "capture",
                        lambda self, carry, pool, stream: captured.append(self))
    model.graphs, model._pool, model._capture_stream = True, None, None
    carry = model.init_carry()
    keys = [("block", 2), ("step",), ("compact",) + model.prefill_variants[0],
            ("marked", 2, 3), ("full", 8)]
    progs = {key: model._program(carry, key) for key in keys}
    assert captured == [progs[k] for k in keys[:3]]
    model.graphs = False
    on = np.zeros((2, B), bool)
    _, _, _, marked = model.decode_block(carry, np.zeros((2, B), np.int32), on, on, on,
                                         logit_rows=np.array([1, 0, 3]))
    assert marked.shape == (2, 3, CFG["vocab_size"])
    model.prefill_step(carry, np.zeros((B, 8), np.int32), np.zeros(B, np.int32))
    assert carry.programs[("marked", 2, 3)] is progs[("marked", 2, 3)]
    assert carry.programs[("full", 8)] is progs[("full", 8)]


def test_no_program_rebinds_a_carry_tensor(dense):
    """A captured graph holds the addresses of the carry's tensors, so no
    method may rebind one: every tensor of the carry keeps its data pointer
    across decode_block, decode_step, prefill_step_compact, insert_slot and
    reset_slot."""
    model = _model(dense)
    carry = model.init_carry()
    before = {k: t.data_ptr() for k, t in _carry_tensors(carry).items()}
    carry = model.insert_slot(carry, 1, None, _Task(temperature=1.0, presence_penalty=0.5,
                                                   forbidden_tokens=(3,)))
    on = np.zeros((3, B), bool)
    on[:, 1] = True
    carry, _, _ = model.decode_block(carry, np.full((3, B), 9, np.int32), on, on, on)
    carry, _, _ = model.decode_step(carry, np.zeros(B, np.int32), on[0], on[0], on[0])
    (P, T), = model.prefill_variants
    lengths = np.zeros(P, np.int32)
    lengths[0] = 5
    carry = model.prefill_step_compact(carry, np.full((P, T), 7, np.int32), lengths,
                                       np.array([2, 0, 1, 3], np.int32)[:P])
    carry = model.reset_slot(carry, 1)
    after = {k: t.data_ptr() for k, t in _carry_tensors(carry).items()}
    assert after == before


def test_block_with_flagged_rows_equals_decode_steps(dense):
    """decode_block(K) draws each step's noise ahead in the order K single
    steps draw it, so at one seed a block with hostile rows (top_p 1 at a
    high temperature; top_k above the candidates' k_max), which take the
    exact draw, samples what K decode_step calls do, and leaves the same
    carry."""
    model = _model(dense)
    K = 3
    tasks = {0: _Task(temperature=2.0, top_p=1.0), 1: _Task(temperature=1.0, top_p=0.9,
                                                           top_k=300),
             2: _Task(temperature=1.0, top_p=0.5, presence_penalty=0.4,
                      frequency_penalty=0.4, penalty_decay=0.99), 3: _Task()}

    def fresh():
        c = model.init_carry()
        for s, t in tasks.items():
            model.insert_slot(c, s, None, t)
        return c

    on = np.ones((K, B), bool)
    fb = on.copy()
    fb[0] = False
    toks = np.array([[11, 12, 13, 14]] * K, np.int32)
    cb, sampled, votes = model.decode_block(fresh(), toks, fb, on, on)
    cs = fresh()
    steps = [model.decode_step(cs, toks[k], on[k], on[k], fb[k])[1] for k in range(K)]
    np.testing.assert_array_equal(sampled.numpy(), torch.stack(steps).numpy())
    for name, t in _carry_tensors(cb).items():
        assert torch.equal(t, _carry_tensors(cs)[name]), name
    assert votes.tolist() == [0, 0]


def test_greedy_block_matches_jax(dense):
    """A K-step greedy block with device feedback, a prompt finishing
    mid-block and penalties on: the port's tokens equal the JAX
    ServingModel's decode_block (Pallas kernels in interpret mode) bit for
    bit, float32 on both sides."""
    jrt = JRuntime(activation_dtype=jnp.float32, wkv_state_dtype=jnp.float32)
    jm = JServing(JConfig(**CFG), jax.tree_util.tree_map(jnp.asarray, dense), jrt,
                  batch_size=B, prefill_chunk=8, interpret_pallas=True)
    tm = _model(dense)
    K = 4
    toks = np.zeros((K, B), np.int32)
    act, dec, fb = (np.zeros((K, B), bool) for _ in range(3))
    act[:, :3] = True
    toks[0, 0], dec[:, 0], fb[1:, 0] = 5, True, True
    toks[:2, 1] = [17, 23]
    dec[1:, 1], fb[2:, 1] = True, True
    toks[0, 2], dec[:, 2], fb[1:, 2] = 301, True, True
    pen = _Task(presence_penalty=0.5, frequency_penalty=0.5, penalty_decay=0.99)
    jc, tc = jm.init_carry(), tm.init_carry()
    for s in range(3):
        jc, tc = jm.insert_slot(jc, s, None, pen), tm.insert_slot(tc, s, None, pen)
    jc, j_toks, _ = jm.decode_block(jc, jnp.asarray(toks), jnp.asarray(fb), jnp.asarray(act),
                                    jnp.asarray(dec))
    tc, t_toks, _ = tm.decode_block(tc, toks, fb, act, dec)
    np.testing.assert_array_equal(t_toks.numpy(), np.asarray(j_toks))
    assert (t_toks.numpy()[:, :3][dec[:, :3]] >= 0).all()


def test_warmup_programs_leave_the_carry_as_it_was(dense):
    """The worker's warm-up runs decode_block at its K, decode_step, each
    compact prefill variant and the batched insert on all-inactive inputs:
    every tensor of the carry is left as init_carry made it; only the
    generator moves on."""
    model = _model(dense)
    worker = Worker("w", lambda: (model, None), None, None, None, batch_size=B,
                    decode_block_size=3, warmup_programs=True)
    worker._init_worker()
    fresh = model.init_carry()
    rng_before = worker.carry.rng.get_state()
    worker._warmup_programs()
    for name, t in _carry_tensors(worker.carry).items():
        assert torch.equal(t, _carry_tensors(fresh)[name]), name
    assert set(worker.carry.programs) == {("block", 3), ("step",), ("insert",)} | {
        ("compact", P, T) for P, T in model.prefill_variants}
    assert not torch.equal(worker.carry.rng.get_state(), rng_before)


def test_engine_with_warmup_serves_the_same_tokens(tmp_path):
    """An engine whose worker warms up its programs before the handshake
    gives the same greedy tokens, in K-step blocks, as one that does not."""
    from chirrup_tpu_torch.engine.structures import ModelLoadConfig

    vocab = write_tiny_vocab(str(tmp_path / "vocab.txt"))
    cfg = ModelLoadConfig(
        model_path="<synthetic>", vocab_path=vocab, vocab_size=VOCAB_SIZE, quantization=None,
        wkv_state_dtype="float32", activation_dtype="float32",
        synthetic_config=dict(n_layer=2, n_embd=128, vocab_size=VOCAB_SIZE, **LORA))

    async def go(warmup):
        eng = AsyncEngineCore()
        await eng.init(worker_num=1, model_config=cfg, batch_size=2, load_timeout=60,
                       decode_block_size=3, device="cpu", warmup_programs=warmup)
        try:
            comp = eng.completion("hello world the", temperature=0.0, max_tokens=7,
                                  stop_tokens=[0])
            return [ev[1] async for ev in comp if ev[0] == "token"]
        finally:
            eng.shutdown()
            eng.join(timeout=10)

    warm = asyncio.run(asyncio.wait_for(go(True), 120))
    cold = asyncio.run(asyncio.wait_for(go(False), 120))
    assert len(warm) >= 1 and warm == cold


def test_block_with_logit_rows_marks_the_raw_logits(dense):
    """decode_block with logit_rows (run eagerly everywhere) samples what the
    block without them does at the same seed, and returns each step's raw
    logits of the marked slots, as decode_step returns them."""
    model = _model(dense)
    K = 2
    on = np.ones((K, B), bool)
    fb = on.copy()
    fb[0] = False
    toks = np.array([[3, 4, 5, 6]] * K, np.int32)

    def fresh():
        c = model.init_carry()
        for s in range(B):
            model.insert_slot(c, s, None, _Task(temperature=1.0, top_p=0.9))
        return c

    _, plain, _ = model.decode_block(fresh(), toks, fb, on, on)
    _, sampled, votes, marked = model.decode_block(fresh(), toks, fb, on, on,
                                                   logit_rows=np.array([2, 0]))
    assert torch.equal(sampled, plain) and votes.tolist() == [0, 0]
    cs = fresh()
    for k in range(K):
        _, _, raw = model.decode_step(cs, toks[k], on[k], on[k], fb[k])
        assert torch.equal(marked[k], raw[[2, 0]].float())
