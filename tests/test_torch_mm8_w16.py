"""The exact w8a16 serving configuration of chirrup_tpu_torch (mm8_core
"pallas") against the JAX package: the core (ops/mm8_cuda.mm8_core_w16, the
plain version on the CPU) against mm8_core_pallas[_stacked] in interpret mode,
the decomposed mm8_matmul and the FFN pair under both packages' "pallas" core,
the bare w8a8 core's counterpart, and a whole ServingModel.

Inputs come from a numpy seed and reach both packages as numpy arrays.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chirrup_tpu.engine.serving import ServingModel as JServing
from chirrup_tpu.models.config import RWKV7Config as JConfig
from chirrup_tpu.models.config import RuntimeConfig as JRuntime
from chirrup_tpu.models.loader import synthetic_params as j_synthetic_params
from chirrup_tpu.ops import mm8 as jmm8
from chirrup_tpu.ops import mm8_pallas
from chirrup_tpu_torch.engine.serving import ServingModel
from chirrup_tpu_torch.models import rwkv7 as tmodel
from chirrup_tpu_torch.models.config import RWKV7Config, RuntimeConfig, resolve_mm8_core
from chirrup_tpu_torch.models.loader import params_from_numpy
from chirrup_tpu_torch.ops import mm8 as tmm8
from chirrup_tpu_torch.ops import mm8_cuda

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden", "serving_logits.npz")
LORA = dict(d_decay_lora=32, d_iclr_lora=32, d_v_lora=16, d_gate_lora=32)
SCALES = ("mx", "rx", "my", "ry")


def _t(a):
    return torch.from_numpy(np.array(a))


def _stacked(rng, L, K, M):
    ws = [jmm8.quantize(jnp.asarray(rng.standard_normal((K, M)).astype(np.float32)
                                    / np.sqrt(K))) for _ in range(L)]
    return {f: np.stack([np.asarray(getattr(w, f)) for w in ws])
            for f in ("q",) + SCALES}


@pytest.fixture
def jax_pallas_core():
    """The JAX package's mm8_matmul on its "pallas" core, in interpret mode
    (thread-local settings, restored after the test)."""
    jmm8.set_default_core("pallas")
    jmm8.set_interpret(True)
    yield
    jmm8.set_default_core("auto")
    jmm8.set_interpret(False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stacked", [False, True])
def test_core_w16_matches_pallas(dtype, stacked):
    """mm8_core_w16's plain version against mm8_core_pallas (unstacked codes,
    the head) and mm8_core_pallas_stacked (layer li of (L, K, M)). Both widen
    the codes to xs's dtype exactly and sum the exact products in float32;
    only the order of the sums differs: 1e-5 of the output's scale."""
    rng = np.random.default_rng(11)
    L, B, K, M, li = 3, 5, 256, 384, 1
    q = rng.integers(-128, 128, (L, K, M)).astype(np.int8)
    xs = rng.standard_normal((B, K)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" \
        else (jnp.bfloat16, torch.bfloat16)
    xj = jnp.asarray(xs, jdt)
    if stacked:
        want = mm8_pallas.mm8_core_pallas_stacked(xj, jnp.asarray(q), li, interpret=True)
        got = mm8_cuda.mm8_core_w16(_t(xs).to(tdt), _t(q), layer=li)
    else:
        want = mm8_pallas.mm8_core_pallas(xj, jnp.asarray(q[li]), interpret=True)
        got = mm8_cuda.mm8_core_w16(_t(xs).to(tdt), _t(q[li]))
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.shape == (B, M)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("stacked", [False, True])
def test_core_a8_bit_equal(stacked):
    """mm8_core_a8 (the int32 output of the w8a8 GEMM) equals mm8_core_pallas_a8
    and mm8_core_pallas_a8_stacked bit for bit: the sums are exact."""
    rng = np.random.default_rng(12)
    L, B, K, M, li = 3, 5, 512, 256, 2
    x8 = rng.integers(-127, 128, (B, K)).astype(np.int8)
    q = rng.integers(-128, 128, (L, K, M)).astype(np.int8)
    if stacked:
        want = mm8_pallas.mm8_core_pallas_a8_stacked(jnp.asarray(x8), jnp.asarray(q), li,
                                                     interpret=True)
        got = mm8_cuda.mm8_core_a8(_t(x8), _t(q), layer=li)
    else:
        want = mm8_pallas.mm8_core_pallas_a8(jnp.asarray(x8), jnp.asarray(q[li]),
                                             interpret=True)
        got = mm8_cuda.mm8_core_a8(_t(x8), _t(q[li]))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("site", ["stacked", "head", "relu2", "mul_in", "ffn"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mm8_matmul_pallas_matches_jax(jax_pallas_core, site, dtype):
    """The port's mm8_matmul (and FFN pair) under core "pallas" against the JAX
    mm8_matmul under set_default_core("pallas"): the same steps (gate in x's
    dtype, xs rounded to x's dtype for the core only, float32 sums and
    corrections), so only the core's summation order differs. float32: 1e-5 of
    the output's scale; bfloat16: one bf16 step of it, 2^-7, for the output's
    own rounding to bf16 after sums that differ in the last float32 bits."""
    rng = np.random.default_rng(13)
    L, B, K, M, li = 2, 4, 256, 512, 1
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" \
        else (jnp.bfloat16, torch.bfloat16)
    x = rng.standard_normal((2, B // 2, K)).astype(np.float32)   # a leading (2, 2) shape
    g = (1 / (1 + np.exp(-rng.standard_normal((2, B // 2, K))))).astype(np.float32)
    w = _stacked(rng, L, K, M)
    wv = _stacked(rng, L, M, K)
    jw = lambda d: jmm8.Mm8Weight(**{f: jnp.asarray(d[f]) for f in d})
    tw = lambda d: tmm8.Mm8Weight(**{f: _t(d[f]) for f in d})
    xj, xt = jnp.asarray(x, jdt), _t(x).to(tdt)
    if site == "head":
        want = jmm8.mm8_matmul(xj, jmm8.Mm8Weight(**{f: jnp.asarray(w[f][li]) for f in w}))
        got = tmm8.mm8_matmul(xt, tmm8.Mm8Weight(**{f: _t(w[f][li]) for f in w}),
                              core="pallas")
    elif site == "ffn":
        want = jmm8.mm8_ffn_matmul(xj, jmm8.LayerIndexed(jw(w), li),
                                   jmm8.LayerIndexed(jw(wv), li))
        got = tmm8.mm8_ffn_matmul(xt, tmm8.LayerIndexed(tw(w), li),
                                  tmm8.LayerIndexed(tw(wv), li), core="pallas")
    else:
        jkw, tkw = {}, {}
        if site == "relu2":
            jkw = tkw = dict(activation="relu2")
        elif site == "mul_in":
            jkw, tkw = dict(mul_in=jnp.asarray(g, jdt)), dict(mul_in=_t(g).to(tdt))
        want = jmm8.mm8_matmul(xj, jmm8.LayerIndexed(jw(w), li), **jkw)
        got = tmm8.mm8_matmul(xt, tmm8.LayerIndexed(tw(w), li), core="pallas", **tkw)
    want = np.asarray(want, np.float32)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("core", ["xla", "xla_a8", "w8a8"])
def test_unsupported_mm8_core_raises(core):
    """The JAX package's plain-XLA cores have no counterpart in the port (their
    port would be the plain version on the card): RuntimeConfig refuses them,
    as it refuses an unknown name."""
    with pytest.raises(ValueError, match="mm8_core"):
        RuntimeConfig(mm8_core=core)
    for name, resolved in (("auto", "pallas_a8"), ("pallas_a8", "pallas_a8"),
                           ("pallas", "pallas")):
        assert resolve_mm8_core(RuntimeConfig(mm8_core=name).mm8_core) == resolved


# ------------------------------------------------------------ ServingModel

INT8_CFG = dict(n_layer=2, n_embd=128, vocab_size=16384, **LORA)


class _Task:
    def __init__(self, temperature=0.0, top_p=0.3, top_k=0, frequency_penalty=0.0,
                 presence_penalty=0.0, penalty_decay=1.0, forbidden_tokens=()):
        self.temperature, self.top_p, self.top_k = temperature, top_p, top_k
        self.frequency_penalty, self.presence_penalty = frequency_penalty, presence_penalty
        self.penalty_decay, self.forbidden_tokens = penalty_decay, forbidden_tokens


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def test_w16_serving_matches_jax_pallas():
    """INT8 at float32 through both ServingModels with mm8_core "pallas" (the
    JAX one with its Pallas WKV kernels and mm8 cores in interpret mode): an
    insert of three slots, a compact prefill chunk with ragged rows and an idle
    pad row, a second insert, then greedy decode steps (penalties on in one
    slot). No R/K/V merge under this core. Greedy tokens are equal; raw logits
    and the slot snapshots agree within 1e-4 of their scale: w8a16 has no
    activation rounding, so only float32 summation order differs."""
    B, T = 4, 8
    dense = _numpy_tree(j_synthetic_params(JConfig(**INT8_CFG), seed=3))
    jrt = JRuntime(activation_dtype=jnp.float32, wkv_state_dtype=jnp.float32,
                   quantization="int8", use_pallas_wkv=True, mm8_core="pallas")
    jm = JServing(JConfig(**INT8_CFG), jax.tree_util.tree_map(jnp.asarray, dense), jrt,
                  batch_size=B, prefill_chunk=T, interpret_pallas=True)
    rt = RuntimeConfig(activation_dtype=torch.float32, wkv_state_dtype=torch.float32,
                       quantization="int8", mm8_core="pallas")
    tm = ServingModel(RWKV7Config(**INT8_CFG), params_from_numpy(dense, device="cpu"), rt,
                      batch_size=B, prefill_chunk=T, device="cpu")
    assert "Wrkv" not in tm.params["blocks"]["att"] and "Wr" in tm.params["blocks"]["att"]
    assert "Wrkv" not in jm.params["blocks"]["att"]
    jc, tc = jm.init_carry(), tm.init_carry()
    pen = _Task(presence_penalty=0.4, frequency_penalty=0.3, penalty_decay=0.99)
    for s, task in ((0, _Task()), (1, pen), (2, _Task())):
        jc, tc = jm.insert_slot(jc, s, None, task), tm.insert_slot(tc, s, None, task)
    rng = np.random.default_rng(1)
    prompts = {0: rng.integers(1, 16384, 9), 1: rng.integers(1, 16384, 6),
               2: rng.integers(1, 16384, 2)}
    lens = (8, 5, 1, 0)
    tokens = np.zeros((B, T), np.int32)
    for s, n in enumerate(lens):
        if n:
            tokens[s, :n] = prompts[s][:n]
    slot_idx = np.arange(B, dtype=np.int32)
    jc = jm.prefill_step_compact(jc, tokens, np.asarray(lens, np.int32), slot_idx)
    tc = tm.prefill_step_compact(tc, tokens, np.asarray(lens, np.int32), slot_idx)
    jc, tc = jm.insert_slot(jc, 3, None, _Task()), tm.insert_slot(tc, 3, None, _Task())
    act = np.ones(B, bool)
    toks = np.array([prompts[0][8], prompts[1][5], prompts[2][1], 77], np.int32)
    fb = np.zeros(B, bool)
    for step in range(3):
        jc, j_tok, j_raw = jm.decode_step(jc, jnp.asarray(toks), jnp.asarray(act),
                                          jnp.asarray(act), jnp.asarray(fb))
        tc, t_tok, t_raw = tm.decode_step(tc, toks, act, act, fb)
        np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok), f"step {step}")
        j_raw = np.asarray(j_raw, np.float32)
        np.testing.assert_allclose(t_raw.numpy(), j_raw, rtol=0,
                                   atol=1e-4 * np.abs(j_raw).max())
        fb = act.copy()
    for s in range(B):
        js, ts = jm.extract_slot(jc, s), tm.extract_slot(tc, s)
        assert ts.elapsed == js.elapsed
        for a, b in ((ts.shift, js.shift), (ts.wkv, js.wkv)):
            a, b = a.float().numpy(), np.asarray(b, np.float32)
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * np.abs(b).max())


def _four_way_agreement(a, b, n_sets=50, seed=5):
    """tests/test_golden_serving_stack.py's MMLU decision rule: argmax over 4
    sampled candidate tokens per position."""
    crng = np.random.default_rng(seed)
    agree = total = 0
    for pos in range(a.shape[0]):
        for _ in range(n_sets):
            cand = crng.choice(a.shape[1], 4, replace=False)
            agree += int(np.argmax(a[pos][cand]) == np.argmax(b[pos][cand]))
            total += 1
    return agree / total


def test_w16_serving_vs_golden():
    """The port's INT8 w8a16 serving stack at float32 against the recorded golden
    logits (L3/C128/V512), within the JAX package's own w8a16 bounds
    (test_golden_serving_stack.py): max |d| < 0.06, mean |d| / mean |golden|
    < 0.04, four-way decision agreement > 0.95."""
    data = np.load(GOLDEN_PATH)
    tokens, expected = data["tokens"], data["logits"]
    cfg = dict(n_layer=3, n_embd=128, vocab_size=512, **LORA)
    params = params_from_numpy(_numpy_tree(j_synthetic_params(JConfig(**cfg), seed=42)),
                               device="cpu")
    rt = RuntimeConfig(activation_dtype=torch.float32, wkv_state_dtype=torch.float32,
                       quantization="int8", mm8_core="pallas")
    model = ServingModel(RWKV7Config(**cfg), params, rt, batch_size=2, device="cpu")
    carry = model.insert_slot(model.init_carry(), 0, None, _Task())
    act = np.array([True, False])
    outs = []
    for t in tokens:
        carry, _, raw = model.decode_step(carry, np.array([t, 0], np.int32), act, act)
        outs.append(raw[0].numpy())
    logits = np.stack(outs)
    d = np.abs(logits - expected)
    assert d.max() < 0.06, d.max()
    assert d.mean() / np.abs(expected).mean() < 0.04
    assert _four_way_agreement(logits, expected) > 0.95


def test_mm8_core_names_and_merged_rkv_guard():
    """One vocabulary for the core everywhere: mm8_matmul reads "auto" as
    "pallas_a8" (the same bits) and refuses the XLA names as RuntimeConfig
    does. A forward over merged R/K/V weights (ServingModel merges them under
    w8a8) refuses the w8a16 core instead of running R/K/V on w8a8 and every
    other product on w8a16."""
    rng = np.random.default_rng(14)
    w = _stacked(rng, 2, 256, 128)
    tw = tmm8.LayerIndexed(tmm8.Mm8Weight(**{f: _t(w[f]) for f in w}), 1)
    x = _t(rng.standard_normal((3, 256)).astype(np.float32))
    torch.testing.assert_close(tmm8.mm8_matmul(x, tw, core="auto"),
                               tmm8.mm8_matmul(x, tw, core="pallas_a8"), rtol=0, atol=0)
    with pytest.raises(ValueError, match="mm8_core"):
        tmm8.mm8_matmul(x, tw, core="xla")
    cfg = RWKV7Config(**INT8_CFG)
    rt = RuntimeConfig(activation_dtype=torch.float32, wkv_state_dtype=torch.float32,
                       quantization="int8")
    dense = _numpy_tree(j_synthetic_params(JConfig(**INT8_CFG), seed=3))
    m = ServingModel(cfg, params_from_numpy(dense, device="cpu"), rt, batch_size=2,
                     device="cpu")
    assert "Wrkv" in m.params["blocks"]["att"]
    state = tmodel.init_state(cfg, 2, device="cpu")
    with pytest.raises(ValueError, match="Wrkv"):
        tmodel.forward_step(m.params, torch.tensor([1, 2], dtype=torch.int32), state,
                            mm8_core="pallas")
