"""The WKV kernels' precision="bf16" mode in chirrup_tpu_torch against the JAX
package: the delta-form update S += S*d + v k^T + sa b^T in the bf16 state
dtype, the state rounded every token, in the fused step, the fused chunk and
the bare recurrence (ops/wkv7_cuda.py, plain versions on the CPU), and served
through RuntimeConfig(wkv_precision="bf16").

Inputs come from a numpy seed and reach both packages as numpy arrays; the JAX
side runs its Pallas kernels in interpret mode, as its own tests do.

Tolerances. One token: y within 1e-2 of its scale and the state within one
bf16 step (2^-7 of the larger magnitude's power of two) per element. A chunk:
the JAX package's own 4e-2 rtol and atol for this mode
(tests/test_wkv7_pallas.py). Both packages round every bf16 operation to
nearest, but XLA on the CPU may keep float32 between elementwise bf16
operations (excess precision) and the float32 sums run in other orders, so a
rounding may land one step apart. (With the JAX version in this repository's
environment the two agree bit for bit on these inputs.)
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
from chirrup_tpu.ops import wkv7_pallas
from chirrup_tpu_torch.engine.serving import ServingModel
from chirrup_tpu_torch.models.config import RWKV7Config, RuntimeConfig
from chirrup_tpu_torch.models.loader import params_from_numpy
from chirrup_tpu_torch.ops.wkv7_cuda import (wkv7_batch, wkv7_batch_reference,
                                             wkv7_chunk_fused, wkv7_step_fused)

N = 64
LORA = dict(d_decay_lora=32, d_iclr_lora=32, d_v_lora=16, d_gate_lora=32)
BF = jnp.bfloat16


def _bf16(x):
    """float32 numpy -> the float32 of its bf16 rounding (both packages then
    start from the same bf16 values)."""
    return np.array(jnp.asarray(x, BF).astype(jnp.float32))


def _counters(values):
    return np.asarray(values, np.int64).astype(np.uint32).view(np.int32)


def _fused_inputs(rng, B, T, H, L):
    """Rows (B, T, C) with a quarter of the decay logits very negative (decays
    near 0, where a product-form update would freeze), parameters (C,), and a
    bf16 state (L, B, N, C); all bf16 values held as float32."""
    C = H * N
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    w = f(B, T, C)
    slow = rng.random(w.shape) < 0.25
    w[slow] = rng.uniform(-9.0, -5.0, int(slow.sum()))
    d = dict(r=f(B, T, C), w=w, k=f(B, T, C), v=f(B, T, C),
             a=(1 / (1 + np.exp(-f(B, T, C)))).astype(np.float32),
             k_k=f(C) * 0.5, k_a=f(C) * 0.5, r_k=f(C) * 0.5, lnw=f(C) * 0.3 + 1.0,
             lnb=f(C) * 0.1, state=f(L, B, N, C) * 0.3)
    return {k: _bf16(x) for k, x in d.items()}


def _t(x, dtype):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def _one_step_ulps(got, want):
    """Largest |got - want| in bf16 steps at the larger magnitude of the two
    (a step is 2^-7 of its power of two)."""
    m = np.maximum(np.abs(got), np.abs(want))
    step = 2.0 ** (np.floor(np.log2(np.maximum(m, 2.0 ** -126))) - 7)
    return float((np.abs(got - want) / step).max())


@pytest.mark.parametrize("rows", ["bfloat16", "float32"])
def test_step_bf16_matches_pallas(rows):
    """(a) wkv7_step_fused(precision="bf16") (plain version) against
    wkv7_pallas_step_fused(precision="bf16", interpret=True) on layer 1 of a
    bf16 state, B 4, H 2, L 2, one row of length 0, dither counters past 2^31,
    rows in bf16 or float32: y within 1e-2 of its scale, the state within one
    bf16 step per element; the length-0 row and the other layer bit for bit."""
    B, H, L, li = 4, 2, 2, 1
    C = H * N
    d = _fused_inputs(np.random.default_rng(11), B, 1, H, L)
    el = _counters([7, 2 ** 31 - 1, 123, 2 ** 32 - 2])
    ln = np.array([1, 1, 0, 1], np.int32)
    jdt, tdt = (BF, torch.bfloat16) if rows == "bfloat16" else (jnp.float32, torch.float32)
    nh = lambda x: jnp.asarray(x.reshape(H, N).T, jdt)
    y_j, s_j = wkv7_pallas.wkv7_pallas_step_fused(
        jnp.asarray(d["state"], BF), li, *(jnp.asarray(d[k][:, 0], jdt) for k in "rwka"),
        jnp.asarray(d["v"][:, 0].reshape(B, H, N).transpose(0, 2, 1), jdt),
        *(jnp.asarray(d[k], jdt) for k in ("k_k", "k_a", "r_k")), nh(d["lnw"]), nh(d["lnb"]),
        jnp.asarray(el), jnp.asarray(ln), interpret=True, precision="bf16")
    y_j = np.asarray(y_j.astype(jnp.float32)).transpose(0, 2, 1).reshape(B, C)
    s_j = np.asarray(s_j.astype(jnp.float32))

    st = _t(d["state"], torch.bfloat16)
    y_t = wkv7_step_fused(st, li, *(_t(d[k][:, 0], tdt) for k in "rwkav"),
                          *(_t(d[k], tdt) for k in ("k_k", "k_a", "r_k", "lnw", "lnb")),
                          torch.from_numpy(el), torch.from_numpy(ln), precision="bf16")
    assert y_t.dtype == tdt and st.dtype == torch.bfloat16
    y_t, s_t = y_t.float().numpy(), st.float().numpy()
    np.testing.assert_allclose(y_t, y_j, rtol=0, atol=1e-2 * np.abs(y_j).max())
    assert _one_step_ulps(s_t[li], s_j[li]) <= 1
    np.testing.assert_array_equal(s_t[li, 2], d["state"][li, 2])
    assert np.all(y_t[2] == 0)
    np.testing.assert_array_equal(s_t[0], d["state"][0])


@pytest.mark.parametrize("P,T,lengths", [(3, 16, (16, 5, 0)), (2, 8, (0, 7))])
def test_chunk_bf16_matches_pallas(P, T, lengths):
    """(b) wkv7_chunk_fused(precision="bf16") (plain version) against
    wkv7_pallas_chunk_fused(precision="bf16", interpret=True) at (P, T) (3,
    16) and (2, 8), ragged lengths including 0: y and the state within the
    JAX test's 4e-2 rtol and atol; y zero past each length, length-0 rows
    bit for bit."""
    H, L, li = 2, 2, 0
    C = H * N
    d = _fused_inputs(np.random.default_rng(12 + T), P, T, H, L)
    el = _counters([2 ** 31 - 5, 9, 3 * 2 ** 30][:P])
    ln = np.asarray(lengths, np.int32)
    nh = lambda x: jnp.asarray(x.reshape(H, N).T, BF)
    y4, s_j = wkv7_pallas.wkv7_pallas_chunk_fused(
        jnp.asarray(d["state"], BF), li, *(jnp.asarray(d[k], BF) for k in "rwka"),
        jnp.asarray(d["v"].reshape(P, T, H, N).transpose(0, 1, 3, 2), BF),
        *(jnp.asarray(d[k], BF) for k in ("k_k", "k_a", "r_k")), nh(d["lnw"]), nh(d["lnb"]),
        jnp.asarray(el), jnp.asarray(ln), interpret=True, precision="bf16")
    y_j = np.asarray(y4.astype(jnp.float32)).transpose(0, 1, 3, 2).reshape(P, T, C)
    s_j = np.asarray(s_j.astype(jnp.float32))

    bf = torch.bfloat16
    st = _t(d["state"], bf)
    y_t = wkv7_chunk_fused(st, li, *(_t(d[k], bf) for k in "rwkav"),
                           *(_t(d[k], bf) for k in ("k_k", "k_a", "r_k", "lnw", "lnb")),
                           torch.from_numpy(el), torch.from_numpy(ln), precision="bf16")
    y_t, s_t = y_t.float().numpy(), st.float().numpy()
    np.testing.assert_allclose(y_t, y_j, rtol=4e-2, atol=4e-2)
    np.testing.assert_allclose(s_t, s_j, rtol=4e-2, atol=4e-2)
    for b, n in enumerate(ln):
        assert np.all(y_t[b, n:] == 0)
        if n == 0:
            np.testing.assert_array_equal(s_t[li, b], d["state"][li, b])
    np.testing.assert_array_equal(s_t[1], d["state"][1])


def _batch_inputs(rng, B, T, H, L):
    """The bare kernel's bf16 inputs: r, w, k (k~), v, a = -kk, b = kk*iclr
    with kk a per-head unit vector, a quarter of the decays near 0, and a
    bf16 state (L, B, N, C); held as float32."""
    C = H * N
    f = lambda *s: (rng.standard_normal(s) * 0.5).astype(np.float32)
    kk = rng.standard_normal((B, T, H, N))
    kk = (kk / np.linalg.norm(kk, axis=-1, keepdims=True)).reshape(B, T, C)
    iclr = 1 / (1 + np.exp(-rng.standard_normal((B, T, C))))
    w = f(B, T, C)
    slow = rng.random(w.shape) < 0.25
    w[slow] = rng.uniform(-9.0, -5.0, int(slow.sum()))
    d = dict(r=f(B, T, C), w=w, k=f(B, T, C), v=f(B, T, C), a=-kk, b=kk * iclr,
             state=(rng.standard_normal((L, B, N, C)) * 0.6).astype(np.float32))
    return {k: _bf16(x) for k, x in d.items()}


@pytest.mark.parametrize("T", [1, 16])
def test_batch_bf16_matches_pallas(T):
    """(c) wkv7_batch(precision="bf16") (plain version) against
    wkv7_pallas_batch(precision="bf16", interpret=True) on layer 1: T = 1
    (_wkv7_pallas_call_t1) within the one-token tolerances, T = 16
    (_wkv7_pallas_call) within 4e-2; lengths 0, 1, T-1 and T, counters past
    2^31; positions past each length zero, the length-0 row and other layers
    bit for bit."""
    B, H, L, li = 4, 2, 3, 1
    d = _batch_inputs(np.random.default_rng(30 + T), B, T, H, L)
    ln = np.array([0, 1, max(T - 1, 1), T], np.int32)
    el = _counters([2 ** 31 - 3, 2 ** 31 - 1, 2 ** 31 - 6, 5])
    rows = [d[k] for k in ("r", "w", "k", "v", "a", "b")]
    y_j, s_j = wkv7_pallas.wkv7_pallas_batch(
        jnp.asarray(d["state"], BF), *(jnp.asarray(x, BF) for x in rows), jnp.asarray(el),
        lengths=jnp.asarray(ln), layer=li, interpret=True, precision="bf16")
    y_j, s_j = np.asarray(y_j.astype(jnp.float32)), np.asarray(s_j.astype(jnp.float32))

    bf = torch.bfloat16
    st = _t(d["state"], bf)
    y_t = wkv7_batch(st, *(_t(x, bf) for x in rows), torch.from_numpy(el),
                     torch.from_numpy(ln), li, precision="bf16")
    y_t, s_t = y_t.float().numpy(), st.float().numpy()
    if T == 1:
        np.testing.assert_allclose(y_t, y_j, rtol=0, atol=1e-2 * np.abs(y_j).max())
        assert _one_step_ulps(s_t[li], s_j[li]) <= 1
    else:
        np.testing.assert_allclose(y_t, y_j, rtol=4e-2, atol=4e-2)
        np.testing.assert_allclose(s_t, s_j, rtol=4e-2, atol=4e-2)
    for b, n in enumerate(ln):
        assert np.all(y_t[b, n:] == 0)
    np.testing.assert_array_equal(s_t[li, 0], d["state"][li, 0])
    for other in (0, 2):
        np.testing.assert_array_equal(s_t[other], d["state"][other])


def _run_port(kernel, precision, state_dtype, seed=40):
    """One call of `kernel` ("step", "chunk" or "batch") through its wrapper on
    the CPU at H 2: returns (state before, lengths, y, state after)."""
    rng = np.random.default_rng(seed)
    B, T, H, L, li = 3, 6, 2, 2, 1
    lengths = np.array([0, 4, 6], np.int32) if kernel != "step" else np.array([0, 1, 1],
                                                                            np.int32)
    el = torch.from_numpy(_counters([5, 2 ** 31 - 2, 77]))
    ln = torch.from_numpy(lengths)
    bf = torch.bfloat16
    if kernel == "batch":
        d = _batch_inputs(rng, B, T, H, L)
        st = _t(d["state"], state_dtype)
        before = st.clone()
        y = wkv7_batch(st, *(_t(d[k], bf) for k in ("r", "w", "k", "v", "a", "b")), el, ln,
                       li, precision=precision)
        return before, lengths, y, st
    d = _fused_inputs(rng, B, T, H, L)
    st = _t(d["state"], state_dtype)
    before = st.clone()
    par = [_t(d[k], bf) for k in ("k_k", "k_a", "r_k", "lnw", "lnb")]
    if kernel == "step":
        y = wkv7_step_fused(st, li, *(_t(d[k][:, 0], bf) for k in "rwkav"), *par, el, ln,
                            precision=precision)[:, None]
    else:
        y = wkv7_chunk_fused(st, li, *(_t(d[k], bf) for k in "rwkav"), *par, el, ln,
                             precision=precision)
    return before, lengths, y, st


@pytest.mark.parametrize("kernel", ["step", "chunk", "batch"])
def test_float32_state_bf16_is_default(kernel):
    """(d) On a float32 state "bf16" is the default arithmetic, bit for bit,
    as wkv7_pallas._parse_precision makes it (bf16_state only for a bf16
    state)."""
    _, _, y_bf, s_bf = _run_port(kernel, "bf16", torch.float32)
    _, _, y_def, s_def = _run_port(kernel, "default", torch.float32)
    assert torch.equal(y_bf, y_def) and torch.equal(s_bf, s_def)


@pytest.mark.parametrize("kernel", ["step", "chunk", "batch"])
def test_bf16_idle_rows_bit_identical(kernel):
    """(e) Under "bf16" a row of length 0 keeps its bf16 state bit for bit
    (negative zeros included), every position past a length is 0, the other
    layer is untouched, and the active rows do move."""
    before, lengths, y, after = _run_port(kernel, "bf16", torch.bfloat16)
    assert after.dtype == torch.bfloat16
    li = 1
    assert torch.equal(after[li, 0].view(torch.int16), before[li, 0].view(torch.int16))
    assert torch.equal(after[0].view(torch.int16), before[0].view(torch.int16))
    for b, n in enumerate(lengths):
        assert bool((y[b, n:] == 0).all())
    assert not torch.equal(after[li, 1:], before[li, 1:])


def test_runtime_config_wkv_precision():
    """(f) RuntimeConfig takes the JAX package's three WKV precisions and
    refuses any other, as the kernel wrappers do."""
    for p in ("highest", "default", "bf16"):
        assert RuntimeConfig(wkv_precision=p).wkv_precision == p
    assert RuntimeConfig().wkv_precision == "default"
    with pytest.raises(ValueError):
        RuntimeConfig(wkv_precision="fast")
    st = torch.zeros((1, 1, N, N), dtype=torch.bfloat16)
    rows = [torch.zeros((1, 1, N)) for _ in range(6)]
    with pytest.raises(ValueError):
        wkv7_batch(st, *rows, torch.zeros(1, dtype=torch.int32), precision="fast")
    with pytest.raises(ValueError):
        wkv7_batch_reference(st[0], *rows, torch.zeros(1, dtype=torch.int32),
                             precision="fast")


# ------------------------------------------------------------- the slice

INT8_CFG = dict(n_layer=2, n_embd=128, vocab_size=16384, **LORA)
B = 4


class _Task:
    def __init__(self, temperature=0.0, top_p=0.3, top_k=0, frequency_penalty=0.0,
                 presence_penalty=0.0, penalty_decay=1.0, forbidden_tokens=()):
        self.temperature, self.top_p, self.top_k = temperature, top_p, top_k
        self.frequency_penalty, self.presence_penalty = frequency_penalty, presence_penalty
        self.penalty_decay, self.forbidden_tokens = penalty_decay, forbidden_tokens


def test_int8_bf16_serving_matches_jax_pallas():
    """(g) The slice: both ServingModels on the tiny INT8 w8a8 config with a
    bf16 state and wkv_precision="bf16" (float32 activations), through one
    compact prefill chunk (ragged, idle rows) and then the mixed sequence of
    inserts, token-by-token prompt feeds, greedy decode with penalties on, a
    reset and a re-insert.

    Logits and slot snapshots are held at 3e-2 of their scale (the bf16
    end-to-end tolerance of chip_smoke.py's small-model checks): an activation
    code may round one step apart between XLA and PyTorch
    (tests/test_torch_serving.py), and in this mode the state then rounds to
    bf16 every token, so such a step moves a state element by a bf16 step
    (2^-8 to 2^-7 of it), where the float32 state of the default mode moved
    by ~1e-6. Greedy tokens are equal wherever the JAX top-2 margin exceeds
    twice the step's largest logits difference, the margin that difference
    cannot reorder; this tiny random model's logits span ~0.2, so its top-2
    margins reach 1e-4. Decode rows take the JAX model's previous token as
    their input (the same token the device feedback would bring it), so a
    near tie does not change the rest of the sequence."""
    dense = jax.tree_util.tree_map(np.asarray, j_synthetic_params(JConfig(**INT8_CFG), seed=3))
    jrt = JRuntime(activation_dtype=jnp.float32, wkv_state_dtype=BF, quantization="int8",
                   use_pallas_wkv=True, mm8_core="pallas_a8", wkv_precision="bf16")
    jm = JServing(JConfig(**INT8_CFG), jax.tree_util.tree_map(jnp.asarray, dense), jrt,
                  batch_size=B, prefill_chunk=8, interpret_pallas=True)
    rt = RuntimeConfig(activation_dtype=torch.float32, wkv_state_dtype=torch.bfloat16,
                       quantization="int8", wkv_precision="bf16")
    tm = ServingModel(RWKV7Config(**INT8_CFG), params_from_numpy(dense, device="cpu"), rt,
                      batch_size=B, prefill_chunk=8, device="cpu")
    jc, tc = jm.init_carry(), tm.init_carry()
    pen = _Task(presence_penalty=0.4, frequency_penalty=0.3, penalty_decay=0.99,
                forbidden_tokens=(7, 11))
    rng = np.random.default_rng(0)

    def close(got, want, what):
        got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
        np.testing.assert_allclose(got, want, rtol=0, atol=3e-2 * np.abs(want).max(),
                                   err_msg=what)

    def snapshots_close(what):
        for s in range(B):
            js, ts = jm.extract_slot(jc, s), tm.extract_slot(tc, s)
            assert ts.elapsed == js.elapsed
            assert ts.wkv.dtype == torch.bfloat16
            close(ts.shift.float(), js.shift, f"{what}: shift slot {s}")
            close(ts.wkv.float(), js.wkv, f"{what}: wkv slot {s}")

    # a compact prefill chunk first: slots 0 and 2 take 8 and 5 prompt tokens
    for s in (0, 2):
        jc, tc = jm.insert_slot(jc, s, None, _Task()), tm.insert_slot(tc, s, None, _Task())
    tokens = rng.integers(1, 16384, (B, 8)).astype(np.int32)
    lengths = np.array([8, 5, 0, 0], np.int32)
    slot_idx = np.array([0, 2, 1, 3], np.int32)
    jc = jm.prefill_step_compact(jc, tokens, lengths, slot_idx)
    tc = tm.prefill_step_compact(tc, tokens, lengths, slot_idx)
    assert [tm.extract_slot(tc, s).elapsed for s in range(B)] == [8, 0, 5, 0]
    snapshots_close("after the prefill chunk")

    # (inserts, tokens, active, decode) per step; slot 1 is reset at step 3
    # and re-inserted at step 4; slot 0 continues its prompt, slot 2 decodes
    prompts = {s: list(rng.integers(1, 16384, 3)) for s in range(B)}
    plan = {0: (1, 3), 4: (1,)}
    phase = {0: list(prompts[0]), 1: None, 2: [], 3: None}
    last = {2: int(prompts[2][0])}
    for step in range(7):
        if step == 3:
            jc, tc = jm.reset_slot(jc, 1), tm.reset_slot(tc, 1)
            phase[1] = None
        for s in plan.get(step, ()):
            task = pen if s != 3 else _Task()
            jc, tc = jm.insert_slot(jc, s, None, task), tm.insert_slot(tc, s, None, task)
            phase[s] = list(prompts[s])
        toks = np.zeros(B, np.int32)
        act, dec = np.zeros(B, bool), np.zeros(B, bool)
        for s, left in phase.items():
            if left is None:
                continue
            act[s] = True
            if left:
                toks[s] = left.pop(0)
                dec[s] = not left
            else:
                toks[s], dec[s] = last[s], True
        fb = np.zeros(B, bool)
        jc, j_tok, j_raw = jm.decode_step(jc, jnp.asarray(toks), jnp.asarray(act),
                                          jnp.asarray(dec), jnp.asarray(fb))
        tc, t_tok, t_raw = tm.decode_step(tc, toks, act, dec, fb)
        j_tok, j_raw = np.asarray(j_tok), np.asarray(j_raw, np.float32)
        t_raw = t_raw.numpy()
        close(t_raw[act], j_raw[act], f"logits step {step}")
        err = np.abs(t_raw[act] - j_raw[act]).max()
        top2 = np.sort(j_raw, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0] > 2 * err) | ~dec
        np.testing.assert_array_equal(t_tok.numpy()[clear], j_tok[clear], f"step {step}")
        for s in np.flatnonzero(dec):
            last[s] = int(j_tok[s])
    snapshots_close("after decoding")
