"""chirrup_tpu_torch ServingModel (the decode slice) against the JAX package.

Both packages start from the same dense parameters (the JAX synthetic tree,
handed over as numpy through params_from_numpy); the port runs on the CPU,
where every kernel is its plain PyTorch version, and the JAX ServingModel runs
its Pallas kernels in interpret mode.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from chirrup_tpu.engine.serving import ServingModel as JServing
from chirrup_tpu.models.config import RWKV7Config as JConfig
from chirrup_tpu.models.config import RuntimeConfig as JRuntime
from chirrup_tpu.models.loader import synthetic_params as j_synthetic_params
from chirrup_tpu_torch.engine.serving import ServingModel
from chirrup_tpu_torch.models.config import RWKV7Config, RuntimeConfig
from chirrup_tpu_torch.models.loader import params_from_numpy

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden", "serving_logits.npz")
LORA = dict(d_decay_lora=32, d_iclr_lora=32, d_v_lora=16, d_gate_lora=32)
F32 = RuntimeConfig(activation_dtype=torch.float32, wkv_state_dtype=torch.float32)


class _Task:
    def __init__(self, temperature=0.0, top_p=0.3, top_k=0, frequency_penalty=0.0,
                 presence_penalty=0.0, penalty_decay=1.0, forbidden_tokens=()):
        self.temperature, self.top_p, self.top_k = temperature, top_p, top_k
        self.frequency_penalty, self.presence_penalty = frequency_penalty, presence_penalty
        self.penalty_decay, self.forbidden_tokens = penalty_decay, forbidden_tokens


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def test_fp32_serving_matches_golden():
    """The port's fp32 decode path reproduces the recorded golden logits of the
    serving stack (L3/C128/V512) within the JAX package's own fp32 tolerance,
    2e-4 absolute."""
    data = np.load(GOLDEN_PATH)
    tokens, expected = data["tokens"], data["logits"]
    cfg = dict(n_layer=3, n_embd=128, vocab_size=512, **LORA)
    params = params_from_numpy(_numpy_tree(j_synthetic_params(JConfig(**cfg), seed=42)),
                               device="cpu")
    model = ServingModel(RWKV7Config(**cfg), params, F32, batch_size=2, device="cpu")
    carry = model.insert_slot(model.init_carry(), 0, None, _Task())
    act = np.array([True, False])
    outs = []
    for t in tokens:
        carry, _, raw = model.decode_step(carry, np.array([t, 0], np.int32), act, act)
        outs.append(raw[0].numpy())
    np.testing.assert_allclose(np.stack(outs), expected, rtol=0, atol=2e-4)


def test_init_state_resolves_device():
    """init_state without a device builds on the CUDA device, and raises where
    there is none (as every entry point of the port does); device="cpu"
    builds on the CPU."""
    from chirrup_tpu_torch.models import rwkv7 as tm

    cfg = RWKV7Config(n_layer=2, n_embd=128, vocab_size=512, **LORA)
    st = tm.init_state(cfg, 2, device="cpu")
    assert {t.device.type for t in (st.shift, st.wkv, st.elapsed)} == {"cpu"}
    assert tuple(st.wkv.shape) == (2, 2, 64, 128)
    if torch.cuda.is_available():
        assert tm.init_state(cfg, 2).wkv.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tm.init_state(cfg, 2)


# ------------------------------------------------------------ int8 w8a8 parity

INT8_CFG = dict(n_layer=2, n_embd=128, vocab_size=16384, **LORA)
B = 4


@pytest.fixture(scope="module")
def int8_models():
    dense = _numpy_tree(j_synthetic_params(JConfig(**INT8_CFG), seed=3))
    jrt = JRuntime(activation_dtype=jnp.float32, wkv_state_dtype=jnp.float32,
                   quantization="int8", use_pallas_wkv=True, mm8_core="pallas_a8")
    jm = JServing(JConfig(**INT8_CFG), jax.tree_util.tree_map(jnp.asarray, dense), jrt,
                  batch_size=B, prefill_chunk=8, interpret_pallas=True)
    rt = RuntimeConfig(activation_dtype=torch.float32, wkv_state_dtype=torch.float32,
                       quantization="int8")
    tm = ServingModel(RWKV7Config(**INT8_CFG), params_from_numpy(dense, device="cpu"), rt,
                      batch_size=B, device="cpu")
    return jm, tm


def test_int8_serving_matches_jax_pallas(int8_models):
    """A mixed sequence of inserts, token-by-token prompt feeds, greedy decode
    with penalties on, a reset and a re-insert, through both ServingModels.
    Greedy tokens must be equal. Raw logits are held at 2e-3 of their scale:
    the w8a8 activation codes are a round() of float products that XLA and
    PyTorch may round differently by one code, and each such code moves an
    output by at most rx*16/256*s (see test_torch_mm8.py); two layers of that
    stay within a few parts per thousand. The slot snapshots mean the same
    thing in both packages and agree within the same tolerance."""
    jm, tm = int8_models
    jc, tc = jm.init_carry(), tm.init_carry()
    pen = _Task(presence_penalty=0.4, frequency_penalty=0.3, penalty_decay=0.99,
                forbidden_tokens=(7, 11))
    # (inserts, tokens, active, decode, feedback) per step; slot 1 is reset at
    # step 3 and re-inserted at step 4
    rng = np.random.default_rng(0)
    prompts = {s: list(rng.integers(1, 16384, 3)) for s in range(B)}
    plan = {0: (0, 1, 2), 4: (1, 3)}
    phase = {s: None for s in range(B)}
    for step in range(7):
        if step == 3:
            jc, tc = jm.reset_slot(jc, 1), tm.reset_slot(tc, 1)
            phase[1] = None
        for s in plan.get(step, ()):
            task = pen if s != 2 else _Task()
            jc, tc = jm.insert_slot(jc, s, None, task), tm.insert_slot(tc, s, None, task)
            phase[s] = list(prompts[s])
        toks = np.zeros(B, np.int32)
        act, dec, fb = (np.zeros(B, bool) for _ in range(3))
        for s, left in phase.items():
            if left is None:
                continue
            act[s] = True
            if left:
                toks[s] = left.pop(0)
                dec[s] = not left  # the last prompt token samples
            else:
                dec[s] = fb[s] = True
        jc, j_tok, j_raw = jm.decode_step(jc, jnp.asarray(toks), jnp.asarray(act),
                                          jnp.asarray(dec), jnp.asarray(fb))
        tc, t_tok, t_raw = tm.decode_step(tc, toks, act, dec, fb)
        np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok), f"step {step}")
        j_raw = np.asarray(j_raw, np.float32)[act]
        scale = np.abs(j_raw).max()
        np.testing.assert_allclose(t_raw.numpy()[act], j_raw, rtol=0, atol=2e-3 * scale)
    for s in (0, 3):
        js, ts = jm.extract_slot(jc, s), tm.extract_slot(tc, s)
        assert ts.elapsed == js.elapsed
        for a, b in ((ts.shift, js.shift), (ts.wkv, js.wkv)):
            a, b = a.float().numpy(), np.asarray(b, np.float32)
            np.testing.assert_allclose(a, b, rtol=0, atol=2e-3 * np.abs(b).max())


def test_decode_block_equals_decode_steps(int8_models):
    """decode_block(K) runs the same K steps as K decode_step calls: with the
    same generator seed the sampled tokens (greedy and sampled rows, device
    feedback, a prompt finishing mid-block) are identical, and so is the
    state."""
    _, tm = int8_models
    K = 4
    toks = np.zeros((K, B), np.int32)
    act, dec, fb = (np.zeros((K, B), bool) for _ in range(3))
    act[:, :3] = True
    toks[0, 0], dec[:, 0], fb[1:, 0] = 5, True, True            # greedy decode
    toks[0, 1], dec[:, 1], fb[1:, 1] = 9, True, True            # sampled decode
    toks[:2, 2] = [17, 23]                                      # prompt, then decode
    dec[1:, 2], fb[2:, 2] = True, True
    tasks = {0: _Task(), 1: _Task(temperature=1.0, top_p=0.9, presence_penalty=0.5,
                                  frequency_penalty=0.5, penalty_decay=0.996),
             2: _Task(temperature=0.7, top_p=0.5)}

    def fresh():
        c = tm.init_carry()
        for s, task in tasks.items():
            c = tm.insert_slot(c, s, None, task)
        return c

    cb, sampled_b, _ = tm.decode_block(fresh(), toks, fb, act, dec)
    cs = fresh()
    steps = []
    for k in range(K):
        cs, s, _ = tm.decode_step(cs, toks[k], act[k], dec[k], fb[k])
        steps.append(s)
    np.testing.assert_array_equal(sampled_b.numpy(), torch.stack(steps).numpy())
    torch.testing.assert_close(cb.state.wkv, cs.state.wkv, rtol=0, atol=0)
    torch.testing.assert_close(cb.occurrence, cs.occurrence, rtol=0, atol=0)


def test_forward_seq_matches_jax():
    """The port's whole-sequence forward (the fused chunk's plain version on
    the CPU) against the JAX forward_seq in float32: logits at every position
    and the advanced state agree to float32 reduction order, 1e-4."""
    from chirrup_tpu.models import rwkv7 as jm
    from chirrup_tpu_torch.models import rwkv7 as tm

    cfg = dict(n_layer=2, n_embd=128, vocab_size=512, **LORA)
    dense = _numpy_tree(j_synthetic_params(JConfig(**cfg), seed=9))
    tokens = np.random.default_rng(4).integers(0, 512, (2, 6)).astype(np.int32)
    j_logits, j_state = jm.forward_seq(jax.tree_util.tree_map(jnp.asarray, dense),
                                       jnp.asarray(tokens), jm.init_state(JConfig(**cfg), 2),
                                       full_output=True)
    state = tm.init_state(RWKV7Config(**cfg), 2, device="cpu")
    t_logits, _ = tm.forward_seq(params_from_numpy(dense, device="cpu"),
                                 torch.from_numpy(tokens), state, full_output=True)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), rtol=0, atol=1e-4)
    for got, want in ((state.shift, j_state.shift), (state.wkv, j_state.wkv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(state.elapsed.numpy(), np.asarray(j_state.elapsed))


@pytest.mark.parametrize("as_dict", [False, True])
def test_params_from_numpy_reads_jax_int8_tree(as_dict):
    """The JAX package's INT8 tree (Mm8Weight objects, or dicts with the same
    five fields) becomes the port's tree with every array unchanged."""
    from chirrup_tpu.models.loader import synthetic_params_int8 as j_int8
    from chirrup_tpu_torch.ops.mm8 import Mm8Weight

    cfg = JConfig(n_layer=2, n_embd=128, vocab_size=512, **LORA)
    tree = _numpy_tree(j_int8(cfg, seed=1, use_numpy=True))
    fields = ("q", "mx", "rx", "my", "ry")
    if as_dict:
        def to_dict(node):
            if hasattr(node, "ry"):
                return {f: getattr(node, f) for f in fields}
            return {k: to_dict(v) for k, v in node.items()} if isinstance(node, dict) else node
        tree = to_dict(tree)
    got = params_from_numpy(tree, device="cpu")
    want_head = tree["head"]
    assert isinstance(got["head"], Mm8Weight)
    assert isinstance(got["blocks"]["ffn"]["Wv"], Mm8Weight)
    for f in fields:
        w = want_head[f] if as_dict else getattr(want_head, f)
        np.testing.assert_array_equal(getattr(got["head"], f).numpy(), np.asarray(w))
    emb = got["emb"]
    assert emb.dtype == torch.bfloat16
    np.testing.assert_array_equal(emb.float().numpy(), np.asarray(tree["emb"], np.float32))
