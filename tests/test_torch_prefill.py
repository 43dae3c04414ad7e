"""chirrup_tpu_torch chunked prefill against the JAX package: the fused chunk
kernel's plain version (ops/wkv7_cuda.py), forward_chunk, the two prefill
steps of ServingModel, and the SEQ_PREFILL phase of the worker and engine.

Inputs come from a numpy seed and reach both packages as numpy arrays. On the
CPU every port kernel runs its plain PyTorch version; the JAX side runs its
Pallas kernels in interpret mode, as its own tests do.
"""

import asyncio
import queue

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chirrup_tpu.engine.serving import ServingModel as JServing
from chirrup_tpu.models import rwkv7 as jmodel
from chirrup_tpu.models.config import RWKV7Config as JConfig
from chirrup_tpu.models.config import RuntimeConfig as JRuntime
from chirrup_tpu.models.loader import synthetic_params as j_synthetic_params
from chirrup_tpu.ops import wkv7_pallas
from chirrup_tpu_torch.engine.serving import ServingModel
from chirrup_tpu_torch.engine.structures import RequestStatus, Task
from chirrup_tpu_torch.engine.worker import SlotPhase, Worker
from chirrup_tpu_torch.models import rwkv7 as tmodel
from chirrup_tpu_torch.models.config import RWKV7Config, RuntimeConfig
from chirrup_tpu_torch.models.loader import params_from_numpy
from chirrup_tpu_torch.ops.wkv7_cuda import (wkv7_chunk_fused, wkv7_chunk_fused_reference,
                                             wkv7_step_fused_reference)

from tests.engine_fixtures import VOCAB_SIZE, synthetic_model_config, write_tiny_vocab

N = 64
LORA = dict(d_decay_lora=32, d_iclr_lora=32, d_v_lora=16, d_gate_lora=32)
DENSE_CFG = dict(n_layer=2, n_embd=128, vocab_size=300, **LORA)
F32 = RuntimeConfig(activation_dtype=torch.float32, wkv_state_dtype=torch.float32)


class _Task:
    def __init__(self, temperature=0.0, top_p=0.3, top_k=0, frequency_penalty=0.0,
                 presence_penalty=0.0, penalty_decay=1.0, forbidden_tokens=()):
        self.temperature, self.top_p, self.top_k = temperature, top_p, top_k
        self.frequency_penalty, self.presence_penalty = frequency_penalty, presence_penalty
        self.penalty_decay, self.forbidden_tokens = penalty_decay, forbidden_tokens


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


# ------------------------------------------------------------------ the kernel

def _chunk_inputs(rng, B, T, H, L, elapsed):
    C = H * N
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(state=(rng.standard_normal((L, B, N, C)) * 0.2).astype(np.float32),
                r=f(B, T, C), w=f(B, T, C), k=f(B, T, C), v=f(B, T, C),
                a=(1 / (1 + np.exp(-f(B, T, C)))).astype(np.float32),
                k_k=f(C) * 0.5, k_a=f(C) * 0.5, r_k=f(C) * 0.5,
                lnw=f(C) * 0.3 + 1.0, lnb=f(C) * 0.1,
                elapsed=np.asarray(elapsed, np.int64).astype(np.uint32).view(np.int32))


def _run_torch_chunk(d, li, lengths):
    t = torch.from_numpy
    st = t(d["state"].copy())
    y = wkv7_chunk_fused(st, li, t(d["r"]), t(d["w"]), t(d["k"]), t(d["a"]), t(d["v"]),
                         t(d["k_k"]), t(d["k_a"]), t(d["r_k"]), t(d["lnw"]), t(d["lnb"]),
                         t(d["elapsed"]), t(np.asarray(lengths, np.int32)))
    return y.numpy(), st.numpy()


@pytest.mark.parametrize("body,B,T,H,L,li,lengths,elapsed", [
    # the grouped body; T 12 is padded to 16 inside the JAX wrapper
    ("grouped", 3, 12, 2, 3, 1, (12, 5, 0), (7, 2 ** 31 - 5, 123)),
    # the T-blocked body; counters whose uint32 reading is past 2^31
    ("tblocked", 8, 16, 2, 2, 0, (16, 9, 3, 0, 16, 1, 8, 11),
     (3 * 2 ** 30, 2 ** 31, 2 ** 31 - 9, 0, 2 ** 32 - 4, 5, 99, 2 ** 31 + 77)),
])
def test_chunk_plain_matches_pallas(monkeypatch, body, B, T, H, L, li, lengths, elapsed):
    """The port's fused chunk (plain version on the CPU) against
    wkv7_pallas_chunk_fused(interpret=True, precision="highest"), through each
    of its two Pallas bodies. float32 with 5e-4, the JAX package's own
    tolerance for this kernel: the Pallas body sums through the 2-dot form and
    segment matmuls, the port directly. Positions past each length are zero;
    length-0 rows and every other layer keep their state bit for bit."""
    if body == "tblocked":
        monkeypatch.setattr(wkv7_pallas, "_pick_batch_tile", lambda *a, **k: 1)
        monkeypatch.setattr(wkv7_pallas, "_pick_batch_tile_blocked",
                            lambda B, *a, **k: 8 if B % 8 == 0 else 0)
    d = _chunk_inputs(np.random.default_rng(5 + B), B, T, H, L, elapsed)
    ln = np.asarray(lengths, np.int32)
    v_nh = d["v"].reshape(B, T, H, N).transpose(0, 1, 3, 2)
    nh = lambda x: jnp.asarray(x.reshape(H, N).T)
    y4, s_j = wkv7_pallas.wkv7_pallas_chunk_fused(
        jnp.asarray(d["state"]), li, *(jnp.asarray(d[k]) for k in ("r", "w", "k", "a")),
        jnp.asarray(v_nh), jnp.asarray(d["k_k"]), jnp.asarray(d["k_a"]),
        jnp.asarray(d["r_k"]), nh(d["lnw"]), nh(d["lnb"]), jnp.asarray(d["elapsed"]),
        jnp.asarray(ln), interpret=True, precision="highest")
    y_j = np.asarray(y4).transpose(0, 1, 3, 2).reshape(B, T, H * N)
    s_j = np.asarray(s_j)

    y_t, s_t = _run_torch_chunk(d, li, ln)
    np.testing.assert_allclose(y_t, y_j, rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(s_t[li], s_j[li], rtol=5e-4, atol=5e-4)
    for b in range(B):
        assert np.all(y_t[b, ln[b]:] == 0)
        if ln[b] == 0:
            np.testing.assert_array_equal(s_t[li, b], d["state"][li, b])
    for other in range(L):
        if other != li:
            np.testing.assert_array_equal(s_t[other], d["state"][other])


def test_chunk_plain_equals_chained_steps():
    """At float32 the chunk's plain version is the decode step's applied token
    by token, with the dither counter elapsed + t: bit for bit, since both run
    the same per-token operations and a float32 state is never rounded."""
    B, T, H = 3, 7, 2
    d = _chunk_inputs(np.random.default_rng(2), B, T, H, 1, (2 ** 31 - 3, 40, 0))
    t = torch.from_numpy
    ln = torch.tensor([7, 4, 0], dtype=torch.int32)
    par = [t(d[k]) for k in ("k_k", "k_a", "r_k", "lnw", "lnb")]
    el = t(d["elapsed"])
    y, s = wkv7_chunk_fused_reference(t(d["state"][0]), t(d["r"]), t(d["w"]), t(d["k"]),
                                      t(d["a"]), t(d["v"]), *par, el, ln)
    st = t(d["state"][0])
    for i in range(T):
        rows = [t(d[k][:, i]) for k in ("r", "w", "k", "a", "v")]
        y_i, st = wkv7_step_fused_reference(st, *rows, *par, el + i,
                                            (i < ln).to(torch.int32))
        np.testing.assert_array_equal(y[:, i].numpy(), y_i.numpy())
    np.testing.assert_array_equal(s.numpy(), st.numpy())


# --------------------------------------------------------------- forward_chunk

def test_forward_chunk_step_equals_seq_and_token_feed():
    """float32, the same dense weights: forward_chunk over the first T-1 tokens
    then forward_step on the last equals forward_seq over all T, equals feeding
    the tokens one by one through forward_step, and the chunk's state equals
    the JAX forward_chunk's. Ragged rows (a row of 3 valid tokens, an empty
    row) match their own unpadded runs. Only float32 reduction order differs
    (batched rows against single rows): 1e-4."""
    dense = _numpy_tree(j_synthetic_params(JConfig(**DENSE_CFG), seed=9))
    params = params_from_numpy(dense, device="cpu")
    cfg = RWKV7Config(**DENSE_CFG)
    B, T = 3, 9
    tokens = np.random.default_rng(4).integers(1, 300, (B, T)).astype(np.int32)
    tt = torch.from_numpy(tokens)

    seq_state = tmodel.init_state(cfg, B, device="cpu")
    seq_logits, _ = tmodel.forward_seq(params, tt, seq_state)
    chunk_state = tmodel.init_state(cfg, B, device="cpu")
    tmodel.forward_chunk(params, tt[:, :-1], chunk_state)
    j_state = jmodel.forward_chunk(jax.tree_util.tree_map(jnp.asarray, dense),
                                   jnp.asarray(tokens[:, :-1]), jmodel.init_state(
                                       JConfig(**DENSE_CFG), B))
    for got, want in ((chunk_state.shift, j_state.shift), (chunk_state.wkv, j_state.wkv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(chunk_state.elapsed.numpy(), np.asarray(j_state.elapsed))
    step_logits, _ = tmodel.forward_step(params, tt[:, -1], chunk_state)
    feed_state = tmodel.init_state(cfg, B, device="cpu")
    for i in range(T):
        feed_logits, _ = tmodel.forward_step(params, tt[:, i], feed_state)
    for logits, st in ((step_logits, chunk_state), (feed_logits, feed_state)):
        np.testing.assert_allclose(logits.numpy(), seq_logits.numpy(), rtol=0, atol=1e-4)
        for a, b in ((st.shift, seq_state.shift), (st.wkv, seq_state.wkv)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-4)
        np.testing.assert_array_equal(st.elapsed.numpy(), seq_state.elapsed.numpy())

    # ragged: row 0 takes 3 tokens, row 1 none, row 2 all 8
    ragged = tmodel.init_state(cfg, B, device="cpu")
    tmodel.forward_step(params, tt[:, 0], ragged)   # a non-zero state to keep
    before = [x.clone() for x in (ragged.shift, ragged.wkv, ragged.elapsed)]
    lengths = torch.tensor([3, 0, 8], dtype=torch.int32)
    tmodel.forward_chunk(params, tt[:, 1:], ragged, lengths)
    np.testing.assert_array_equal(ragged.elapsed.numpy(), before[2].numpy() + [3, 0, 8])
    np.testing.assert_array_equal(ragged.wkv[:, 1].numpy(), before[1][:, 1].numpy())
    np.testing.assert_array_equal(ragged.shift[:, :, 1].numpy(), before[0][:, :, 1].numpy())
    for row, n in ((0, 3), (2, 8)):
        alone = tmodel.init_state(cfg, 1, device="cpu")
        tmodel.forward_step(params, tt[row:row + 1, 0], alone)
        tmodel.forward_chunk(params, tt[row:row + 1, 1:1 + n], alone)
        np.testing.assert_allclose(ragged.wkv[:, row].numpy(), alone.wkv[:, 0].numpy(),
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(ragged.shift[:, :, row].numpy(),
                                   alone.shift[:, :, 0].numpy(), rtol=0, atol=1e-4)


# --------------------------------------------------------------- prefill steps

def _dense_model(batch):
    dense = _numpy_tree(j_synthetic_params(JConfig(**DENSE_CFG), seed=3))
    return ServingModel(RWKV7Config(**DENSE_CFG), params_from_numpy(dense, device="cpu"),
                        F32, batch, prefill_chunk=8, device="cpu")


def test_prefill_variants_follow_the_jax_formula():
    """prefill_slots and prefill_variants as the JAX ServingModel computes them
    (serving.py:316-325): [(8, 64)] at batch 64, [(8, 256), (32, 64)] at 256."""
    from chirrup_tpu_torch.models.loader import synthetic_params

    cfg = RWKV7Config(n_layer=1, n_embd=64, vocab_size=64)
    params = synthetic_params(cfg, device="cpu")
    for B, P, variants in ((64, 8, [(8, 64)]), (256, 32, [(8, 256), (32, 64)]),
                           (16, 8, [(8, 64)]), (4, 4, [(4, 64)])):
        m = ServingModel(cfg, params, RuntimeConfig(), B, device="cpu")
        assert (m.prefill_slots, m.prefill_variants) == (P, variants), B


def test_compact_prefill_equals_full_prefill():
    """prefill_step_compact (gather P rows, chunk, write back) leaves the same
    state as the full-batch masked prefill_step, bit for bit: each row's
    arithmetic does not depend on which other rows share the chunk, and the
    pad rows, pointed at idle slots, pass their state through unchanged."""
    B = 16
    model = _dense_model(B)
    assert model.prefill_slots == 8 and model.prefill_variants == [(8, 8)]
    rng = np.random.default_rng(0)
    dirty = rng.integers(1, 290, (B,)).astype(np.int32)
    carries = []
    for _ in range(2):
        c = model.init_carry()
        model.decode_step(c, dirty, np.ones(B, bool), np.ones(B, bool))
        carries.append(c)
    c_full, c_comp = carries
    T = model.prefill_chunk
    fed = {2: rng.integers(1, 290, (T,)), 7: rng.integers(1, 290, (3,)),
           11: rng.integers(1, 290, (T,))}
    tokens = np.zeros((B, T), np.int32)
    lengths = np.zeros((B,), np.int32)
    for idx, chunk in fed.items():
        tokens[idx, :len(chunk)] = chunk
        lengths[idx] = len(chunk)
    model.prefill_step(c_full, tokens, lengths)

    P = model.prefill_slots
    slot_idx = np.array(list(fed) + [i for i in range(B) if i not in fed][:P - len(fed)],
                        np.int32)
    model.prefill_step_compact(c_comp, tokens[slot_idx], lengths[slot_idx], slot_idx)
    for name in ("shift", "wkv", "elapsed"):
        np.testing.assert_array_equal(getattr(c_comp.state, name).numpy(),
                                      getattr(c_full.state, name).numpy(), err_msg=name)


INT8_CFG = dict(n_layer=2, n_embd=128, vocab_size=16384, **LORA)


def test_int8_compact_prefill_then_decode_matches_jax():
    """INT8 w8a8 at float32 through both ServingModels: two compact chunks
    (ragged rows, an idle pad row) then greedy decode steps, penalties on in one
    slot. Greedy tokens are equal; states after the prefill and raw logits are
    held at 2e-3 of their scale, as the decode-path parity test holds them (an
    activation code may round one step apart between XLA and PyTorch)."""
    B, T = 4, 8
    dense = _numpy_tree(j_synthetic_params(JConfig(**INT8_CFG), seed=3))
    jrt = JRuntime(activation_dtype=jnp.float32, wkv_state_dtype=jnp.float32,
                   quantization="int8", use_pallas_wkv=True, mm8_core="pallas_a8")
    jm = JServing(JConfig(**INT8_CFG), jax.tree_util.tree_map(jnp.asarray, dense), jrt,
                  batch_size=B, prefill_chunk=T, interpret_pallas=True)
    rt = RuntimeConfig(activation_dtype=torch.float32, wkv_state_dtype=torch.float32,
                       quantization="int8")
    tm = ServingModel(RWKV7Config(**INT8_CFG), params_from_numpy(dense, device="cpu"), rt,
                      batch_size=B, prefill_chunk=T, device="cpu")
    assert tm.prefill_variants == jm.prefill_variants == [(B, T)]
    jc, tc = jm.init_carry(), tm.init_carry()
    pen = _Task(presence_penalty=0.4, frequency_penalty=0.3, penalty_decay=0.99)
    for s, task in ((0, _Task()), (1, pen), (2, _Task())):
        jc, tc = jm.insert_slot(jc, s, None, task), tm.insert_slot(tc, s, None, task)
    rng = np.random.default_rng(1)
    prompts = {0: rng.integers(1, 16384, 13), 1: rng.integers(1, 16384, 6),
               2: rng.integers(1, 16384, 9)}
    slot_idx = np.arange(B, dtype=np.int32)
    for lens, start in (((8, 5, 8, 0), 0), ((4, 0, 0, 0), 8)):
        tokens = np.zeros((B, T), np.int32)
        for s, n in enumerate(lens):
            if n:
                tokens[s, :n] = prompts[s][start:start + n]
        lengths = np.asarray(lens, np.int32)
        jc = jm.prefill_step_compact(jc, tokens, lengths, slot_idx)
        tc = tm.prefill_step_compact(tc, tokens, lengths, slot_idx)
    for s in range(B):
        js, ts = jm.extract_slot(jc, s), tm.extract_slot(tc, s)
        assert ts.elapsed == js.elapsed == {0: 12, 1: 5, 2: 8, 3: 0}[s]
        for a, b in ((ts.shift, js.shift), (ts.wkv, js.wkv)):
            a, b = a.float().numpy(), np.asarray(b, np.float32)
            np.testing.assert_allclose(a, b, rtol=0, atol=2e-3 * max(np.abs(b).max(), 1e-6))
    act = np.array([True, True, True, False])
    toks = np.array([prompts[0][12], prompts[1][5], prompts[2][8], 0], np.int32)
    fb = np.zeros(B, bool)
    for step in range(4):
        jc, j_tok, j_raw = jm.decode_step(jc, jnp.asarray(toks), jnp.asarray(act),
                                          jnp.asarray(act), jnp.asarray(fb))
        tc, t_tok, t_raw = tm.decode_step(tc, toks, act, act, fb)
        np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok), f"step {step}")
        j_raw = np.asarray(j_raw, np.float32)[act]
        np.testing.assert_allclose(t_raw.numpy()[act], j_raw, rtol=0,
                                   atol=2e-3 * np.abs(j_raw).max())
        fb = act.copy()


# ---------------------------------------------------------------- the worker

class _StubModel:
    """Just enough ServingModel surface for _fill_slots."""

    prefill_slots = 32

    def insert_slot(self, carry, slot, state, task):
        return carry

    def insert_slots_batched(self, carry, mask, tasks):
        return carry


def _task(n_tokens, out_q=None):
    return Task(output_queue=out_q or queue.Queue(), task_event_queue=queue.Queue(),
                prompt_str="x", prefill_tokens=list(range(1, n_tokens + 1)), state=None)


def _worker(batch_size=8):
    w = Worker("w0", model_factory=lambda: (None, None), task_queue=queue.Queue(),
               master_event_queue=queue.Queue(), worker_event_queue=queue.Queue(),
               batch_size=batch_size)
    w.model = _StubModel()
    w.tokenizer = None
    w.carry = object()
    return w


def _phases(w):
    return [s.phase for s in w.slots]


def test_short_prompts_not_charged_against_prefill_cap():
    """Counterpart of tests/test_admission.py: only SEQ_PREFILL-bound prompts
    count against max_prefill_count."""
    w = _worker(8)
    assert w.max_prefill_count == 1
    w.task_queue.put(_task(40))
    for _ in range(6):
        w.task_queue.put(_task(3))
    w._fill_slots()
    ph = _phases(w)
    assert ph.count(SlotPhase.SEQ_PREFILL) == 1
    assert sum(p in (SlotPhase.ONE_PREFILL, SlotPhase.DECODE) for p in ph) == 6
    assert not w._deferred_tasks


def test_over_cap_long_prompts_defer_without_blocking_shorts():
    w = _worker(8)
    w.task_queue.put(_task(40))
    w.task_queue.put(_task(40))
    for _ in range(3):
        w.task_queue.put(_task(3))
    w._fill_slots()
    ph = _phases(w)
    assert ph.count(SlotPhase.SEQ_PREFILL) == 1
    assert sum(p in (SlotPhase.ONE_PREFILL, SlotPhase.DECODE) for p in ph) == 3
    assert len(w._deferred_tasks) == 1
    assert len(w._deferred_tasks[0].prefill_tokens) == 40
    for s in w.slots:
        if s.phase == SlotPhase.SEQ_PREFILL:
            s.phase = SlotPhase.DECODE
    w._fill_slots()
    assert _phases(w).count(SlotPhase.SEQ_PREFILL) == 1
    assert not w._deferred_tasks


def test_short_seq_prompts_ride_blocks_when_cap_saturated():
    w = _worker(8)
    w.decode_block_size = 16           # burst max = 4 * 16 = 64 tokens
    w.task_queue.put(_task(200))
    for _ in range(5):
        w.task_queue.put(_task(21))
    w.task_queue.put(_task(200))
    w._fill_slots()
    ph = _phases(w)
    assert ph.count(SlotPhase.SEQ_PREFILL) == 1
    assert ph.count(SlotPhase.ONE_PREFILL) == 5
    assert len(w._deferred_tasks) == 1
    assert len(w._deferred_tasks[0].prefill_tokens) == 200
    w2 = _worker(8)
    w2.decode_block_size = 16
    w2.task_queue.put(_task(21))
    w2._fill_slots()
    assert _phases(w2).count(SlotPhase.SEQ_PREFILL) == 1


def test_cap_still_bounds_bulk_prefills():
    w = _worker(32)
    assert w.max_prefill_count == 4
    for _ in range(10):
        w.task_queue.put(_task(40))
    w._fill_slots()
    assert _phases(w).count(SlotPhase.SEQ_PREFILL) == 4
    assert len(w._deferred_tasks) == 6


def test_failed_admission_takes_no_prefill_row():
    """A long prompt whose admission fails is aborted with a completion event
    and does not count against the cap (the JAX worker counts it before the
    insert and never takes it back): the next long prompt still gets the one
    prefill row."""
    w = _worker(8)
    out = queue.Queue()
    bad = _task(40, out)
    bad.temperature = "hot"  # not a number: its admission raises
    good = _task(40)
    w.task_queue.put(bad)
    w.task_queue.put(good)
    w._fill_slots()
    assert bad.request_status == RequestStatus.FINISHED_ABORTED
    assert out.get_nowait() == ("task_completed", bad)
    assert _phases(w).count(SlotPhase.SEQ_PREFILL) == 1
    assert any(s.task is good and s.phase == SlotPhase.SEQ_PREFILL for s in w.slots)
    assert not w._deferred_tasks


def test_compact_prefill_through_worker(tmp_path):
    """Counterpart of tests/test_prefill_compact.py: the worker prefills a long
    prompt through prefill_step_compact on P rows with distinct slots, reports
    the chunks in its performance events, and completes the request."""
    from chirrup_tpu_torch.utils.tokenizer import WorldTokenizer

    tok = WorldTokenizer(write_tiny_vocab(str(tmp_path / "vocab.txt")))
    model = _dense_model(16)
    calls = []
    orig = model.prefill_step_compact

    def spy(carry, tokens, lengths, slot_idx):
        calls.append((np.asarray(tokens).shape, list(np.asarray(slot_idx)),
                      list(np.asarray(lengths))))
        return orig(carry, tokens, lengths, slot_idx)

    model.prefill_step_compact = spy
    events = queue.Queue()
    w = Worker("w0", lambda: (model, tok), queue.Queue(), queue.Queue(), events,
               batch_size=16, decode_block_size=1)
    w._init_worker()
    task = Task(output_queue=queue.Queue(), task_event_queue=queue.Queue(), prompt_str="",
                state=None, max_tokens=4, stop_tokens=set(), temperature=0.0, top_p=0.0,
                prefill_tokens=[int(t) for t in
                                np.random.default_rng(1).integers(1, 290, (40,))])
    w.task_queue.put(task)
    for _ in range(60):
        w.run_once()
        if task.is_finished():
            break
    assert task.request_status == RequestStatus.FINISHED_LENGTH_CAPPED
    assert len(task.generated_tokens) == 4
    assert calls, "compact prefill was never dispatched"
    assert all(shape == (model.prefill_slots, 8) for shape, _, _ in calls)
    for _, idx, _ in calls:
        assert len(set(idx)) == len(idx)
    # 40 tokens: chunks of 8 while at least 10 remain after the first, then the
    # ONE_PREFILL tail through the decode step
    assert [ln[0] for _, _, ln in calls] == [8, 8, 8, 8]
    seq = []
    while not events.empty():
        _, kind, payload = events.get_nowait()
        if kind == "worker_performance":
            seq.append(payload["task_details"]["seq_prefill_count"])
    assert sum(seq) == len(calls)


def test_long_prompt_chunked_prefill_matches_jax_engine(tmp_path):
    """Counterpart of tests/test_engine.py::test_long_prompt_chunked_prefill: a
    prompt far longer than prefill_chunk (8) goes through many SEQ_PREFILL
    chunks, the ONE_PREFILL tail and greedy decode in both engines, on the same
    float32 weights; the tokens must be equal."""
    from chirrup_tpu.engine.engine import AsyncEngineCore as JEngine
    from chirrup_tpu_torch.engine.engine import AsyncEngineCore
    from chirrup_tpu_torch.engine.structures import ModelLoadConfig
    from chirrup_tpu_torch.utils.tokenizer import WorldTokenizer

    vocab = write_tiny_vocab(str(tmp_path / "vocab.txt"))
    prompt = " ".join(["hello world the User says hello to the Assistant"] * 12)
    synth = dict(n_layer=2, n_embd=128, vocab_size=VOCAB_SIZE, **LORA)

    async def greedy(engine):
        comp = engine.completion(prompt, temperature=0.0, max_tokens=4, stop_tokens=[0],
                                 presence_penalty=0.0, frequency_penalty=0.0)
        return [ev[1] async for ev in comp if ev[0] == "token"]

    async def run_jax():
        eng = JEngine()
        await eng.init(worker_num=1, model_config=synthetic_model_config(vocab),
                       batch_size=4, load_timeout=120)
        try:
            assert len(eng.tokenizer.encode(prompt)) > 80
            return await greedy(eng)
        finally:
            eng.shutdown()

    chunks = []

    def factory():
        dense = _numpy_tree(j_synthetic_params(JConfig(**synth), seed=0))
        model = ServingModel(RWKV7Config(**synth), params_from_numpy(dense, device="cpu"),
                             F32, 4, prefill_chunk=8, device="cpu")
        orig = model.prefill_step_compact

        def spy(carry, tokens, lengths, slot_idx):
            chunks.append(int(np.asarray(lengths).max()))
            return orig(carry, tokens, lengths, slot_idx)

        model.prefill_step_compact = spy
        return model, WorldTokenizer(vocab)

    async def run_port():
        eng = AsyncEngineCore()
        cfg = ModelLoadConfig(model_path="<synthetic>", vocab_path=vocab,
                              vocab_size=VOCAB_SIZE, quantization=None,
                              wkv_state_dtype="float32", activation_dtype="float32",
                              prefill_chunk=8, synthetic_config=synth)
        await eng.init(worker_num=1, model_config=cfg, batch_size=4, load_timeout=60,
                       model_factory=factory, device="cpu")
        try:
            return await greedy(eng)
        finally:
            eng.shutdown()
            eng.join(timeout=10)

    want = asyncio.run(asyncio.wait_for(run_jax(), 240))
    got = asyncio.run(asyncio.wait_for(run_port(), 120))
    assert len(chunks) >= 10 and max(chunks) == 8   # batch 4: compact rows = the batch
    assert len(want) >= 1
    assert got == want
