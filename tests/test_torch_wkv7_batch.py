"""The bare WKV7 recurrence of chirrup_tpu_torch (ops/wkv7_cuda.wkv7_batch, the
plain version on the CPU) and the unfused TMix path that drives it (wkv_fn on
forward_step / forward_chunk / forward_seq), against the JAX package's
wkv7_pallas_batch in interpret mode and its forwards with that wkv_fn.

Inputs come from a numpy seed and reach both packages as numpy arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chirrup_tpu.models import rwkv7 as jmodel
from chirrup_tpu.models.config import RWKV7Config as JConfig
from chirrup_tpu.models.loader import synthetic_params as j_synthetic_params
from chirrup_tpu.ops import wkv7_pallas
from chirrup_tpu_torch.models import rwkv7 as tmodel
from chirrup_tpu_torch.models.config import RWKV7Config
from chirrup_tpu_torch.models.loader import params_from_numpy
from chirrup_tpu_torch.ops.wkv7_cuda import wkv7_batch, wkv7_batch_reference

N = 64
LORA = dict(d_decay_lora=32, d_iclr_lora=32, d_v_lora=16, d_gate_lora=32)


def _inputs(rng, B, T, H, L):
    C = H * N
    f = lambda *s: (rng.standard_normal(s) * 0.5).astype(np.float32)
    kk = rng.standard_normal((B, T, H, N))
    kk = (kk / np.linalg.norm(kk, axis=-1, keepdims=True)).reshape(B, T, C)
    iclr = 1 / (1 + np.exp(-rng.standard_normal((B, T, C))))
    return dict(state=(rng.standard_normal((L, B, N, C)) * 0.3).astype(np.float32),
                r=f(B, T, C), w=f(B, T, C), k=f(B, T, C), v=f(B, T, C),
                a=(-kk).astype(np.float32), b=(kk * iclr).astype(np.float32))


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [1, 5, 9])
def test_wkv7_batch_matches_pallas(T, state_dtype):
    """wkv7_batch (plain version) on layer li of a stacked state against
    wkv7_pallas_batch(layer=li, precision="highest", interpret=True): T = 1
    (the _wkv7_pallas_call_t1 body), 5 and 9 (_wkv7_pallas_call, T padded to 8
    and 16 inside the JAX wrapper), lengths 0, 1, T-1 and T, dither counters
    that cross 2^31 within the chunk. y is held at 1e-4 of its scale (float32;
    the Pallas body sums through the 2-dot form and segment matmuls, the port
    directly). The state at the same for float32; a bf16 state also within one
    bf16 step of its value (both round a float32 state once, at the end).
    Positions past a length are zero; length-0 rows and other layers keep their
    state bit for bit."""
    rng = np.random.default_rng(20 + T)
    B, H, L, li = 4, 2, 3, 1
    d = _inputs(rng, B, T, H, L)
    lengths = np.array([0, 1, T - 1, T], np.int32)
    elapsed = (np.array([2 ** 31 - 3, 2 ** 31 - 1, 2 ** 31 - 6, 5], np.int64)
               .astype(np.uint32).view(np.int32))
    jdt, tdt = (jnp.float32, torch.float32) if state_dtype == "float32" \
        else (jnp.bfloat16, torch.bfloat16)
    state0 = np.asarray(jnp.asarray(d["state"], jdt).astype(jnp.float32))
    rows = [d[k] for k in ("r", "w", "k", "v", "a", "b")]
    y_j, s_j = wkv7_pallas.wkv7_pallas_batch(
        jnp.asarray(state0, jdt), *(jnp.asarray(x) for x in rows), jnp.asarray(elapsed),
        lengths=jnp.asarray(lengths), layer=li, interpret=True, precision="highest")
    y_j, s_j = np.asarray(y_j), np.asarray(s_j.astype(jnp.float32))

    st = torch.from_numpy(state0.copy()).to(tdt)
    y_t = wkv7_batch(st, *(torch.from_numpy(x) for x in rows), torch.from_numpy(elapsed),
                     torch.from_numpy(lengths), li).numpy()
    s_t = st.float().numpy()
    np.testing.assert_allclose(y_t, y_j, rtol=0, atol=1e-4 * np.abs(y_j).max())
    s_tol = 1e-4 * np.abs(s_j[li]).max()
    if state_dtype == "bfloat16":
        s_tol = s_tol + 2.0 ** -7 * np.abs(s_j[li])
    np.testing.assert_array_less(np.abs(s_t[li] - s_j[li]), s_tol + 1e-30)
    for b in range(B):
        assert np.all(y_t[b, lengths[b]:] == 0)
    np.testing.assert_array_equal(s_t[li, 0], state0[li, 0])
    for other in range(L):
        if other != li:
            np.testing.assert_array_equal(s_t[other], state0[other])


@pytest.mark.parametrize("precision,error", [("fast", ValueError)])
def test_wkv7_batch_precision(precision, error):
    """"highest" and "default" both run the float32 state; a precision the JAX
    package does not have is refused by the kernel wrapper and its plain
    version alike ("bf16": tests/test_torch_wkv7_bf16.py)."""
    d = _inputs(np.random.default_rng(1), 2, 3, 1, 1)
    rows = [torch.from_numpy(d[k]) for k in ("r", "w", "k", "v", "a", "b")]
    el = torch.zeros(2, dtype=torch.int32)
    st = torch.from_numpy(d["state"])
    outs = [wkv7_batch(st.clone(), *rows, el, None, 0, precision=p)
            for p in ("highest", "default")]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    with pytest.raises(error):
        wkv7_batch(st, *rows, el, None, 0, precision=precision)
    with pytest.raises(error):
        wkv7_batch_reference(st[0], *rows, el, precision=precision)


# ------------------------------------------------------------ unfused TMix

DENSE_CFG = dict(n_layer=2, n_embd=128, vocab_size=300, **LORA)


def _jax_raw_wkv(s, r, w, k, v, a, b, e, lengths, layer):
    return wkv7_pallas.wkv7_pallas_batch(s, r, w, k, v, a, b, e, lengths=lengths,
                                         layer=layer, interpret=True)


@pytest.mark.parametrize("entry", ["step", "chunk", "seq"])
def test_unfused_forward_matches_jax(entry):
    """The port's forward_step / forward_chunk / forward_seq with
    wkv_fn=wkv7_batch against the JAX forwards with the raw wkv7_pallas_batch
    wkv_fn (tests/test_model_oracle.py), float32 dense weights: logits and the
    advanced state within 1e-4 (float32 summation order only). The chunk runs
    ragged rows, one of them empty."""
    dense = _numpy_tree(j_synthetic_params(JConfig(**DENSE_CFG), seed=9))
    jparams = jax.tree_util.tree_map(jnp.asarray, dense)
    params = params_from_numpy(dense, device="cpu")
    B, T = 3, 6
    tokens = np.random.default_rng(4).integers(1, 300, (B, T)).astype(np.int32)
    tt = torch.from_numpy(tokens)
    j_state = jmodel.init_state(JConfig(**DENSE_CFG), B)
    state = tmodel.init_state(RWKV7Config(**DENSE_CFG), B, device="cpu")
    j_logits = t_logits = None
    if entry == "step":
        j_logits, j_state = jmodel.forward_step(jparams, jnp.asarray(tokens[:, 0]), j_state,
                                                wkv_fn=_jax_raw_wkv)
        t_logits, _ = tmodel.forward_step(params, tt[:, 0], state, wkv_fn=wkv7_batch)
    elif entry == "chunk":
        lengths = np.array([6, 0, 4], np.int32)
        j_state = jmodel.forward_chunk(jparams, jnp.asarray(tokens), j_state,
                                       jnp.asarray(lengths), wkv_fn=_jax_raw_wkv)
        tmodel.forward_chunk(params, tt, state, torch.from_numpy(lengths), wkv_fn=wkv7_batch)
    else:
        j_logits, j_state = jmodel.forward_seq(jparams, jnp.asarray(tokens), j_state,
                                               full_output=True, wkv_fn=_jax_raw_wkv)
        t_logits, _ = tmodel.forward_seq(params, tt, state, full_output=True,
                                         wkv_fn=wkv7_batch)
    if j_logits is not None:
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), rtol=0, atol=1e-4)
    for got, want in ((state.shift, j_state.shift), (state.wkv, j_state.wkv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(state.elapsed.numpy(), np.asarray(j_state.elapsed))


@pytest.mark.parametrize("entry", ["step", "chunk"])
def test_unfused_forward_equals_fused(entry):
    """Within the port, at float32: the unfused TMix (wkv_fn=wkv7_batch, the kk
    / k~ glue and GroupNorm + bonus outside the recurrence) and the fused WKV
    kernels (wkv_fn=None) give the same logits and state within 1e-4. With
    lengths, the masked positions differ (ln_b against 0) but never reach the
    state."""
    dense = _numpy_tree(j_synthetic_params(JConfig(**DENSE_CFG), seed=10))
    params = params_from_numpy(dense, device="cpu")
    B, T = 3, 7
    tt = torch.from_numpy(np.random.default_rng(6).integers(1, 300, (B, T)).astype(np.int32))
    states = [tmodel.init_state(RWKV7Config(**DENSE_CFG), B, device="cpu") for _ in range(2)]
    outs = []
    for st, fn in zip(states, (None, wkv7_batch)):
        if entry == "step":
            active = torch.tensor([True, False, True])
            outs.append(tmodel.forward_step(params, tt[:, 0], st, active, wkv_fn=fn)[0])
        else:
            tmodel.forward_chunk(params, tt, st, torch.tensor([7, 2, 0], dtype=torch.int32),
                                 wkv_fn=fn)
    if outs:
        torch.testing.assert_close(outs[1][[0, 2]], outs[0][[0, 2]], rtol=0, atol=1e-4)
    for name in ("shift", "wkv"):
        torch.testing.assert_close(getattr(states[1], name), getattr(states[0], name),
                                   rtol=0, atol=1e-4)
    torch.testing.assert_close(states[1].elapsed, states[0].elapsed, rtol=0, atol=0)


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)
