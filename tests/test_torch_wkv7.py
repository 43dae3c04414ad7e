"""chirrup_tpu_torch WKV7 (ops/wkv7.py, ops/wkv7_cuda.py) against the JAX package.

Inputs come from a numpy seed and go through both sides as numpy arrays. On the
CPU the port's fused-step wrapper runs the kernel's plain version; the JAX side
runs its Pallas kernel in interpret mode, as its own tests do.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from chirrup_tpu.ops import wkv7 as jwkv
from chirrup_tpu.ops.wkv7_pallas import wkv7_pallas_step_fused
from chirrup_tpu_torch.ops import wkv7 as twkv
from chirrup_tpu_torch.ops.wkv7_cuda import wkv7_step_fused

N = 64


def test_dither_bit_equal_past_2_31():
    """The rotator1 dither is integer arithmetic plus one exact scaling: equal
    bits are required, including counters whose uint32 product wraps and whose
    int32 reading is negative (counters >= 2^31)."""
    counters = np.array([0, 1, 7, 12345, 2 ** 20 + 3, 2 ** 31 - 1, 2 ** 31,
                         2 ** 31 + 12345, 3 * 2 ** 30, 2 ** 32 - 1], np.uint64)
    as_int32 = counters.astype(np.uint32).view(np.int32)
    expected = np.asarray(jwkv.dither(jnp.asarray(as_int32)))
    got_int32 = twkv.dither(torch.from_numpy(as_int32)).numpy()
    got_int64 = twkv.dither(torch.from_numpy(counters.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got_int32.view(np.uint32), expected.view(np.uint32))
    np.testing.assert_array_equal(got_int64.view(np.uint32), expected.view(np.uint32))


def group_norm(x, num_groups, w, b, eps):
    """Per-head GroupNorm over (..., C) with C = num_groups * head_size."""
    shape = x.shape
    xf = x.to(torch.float32).reshape(*shape[:-1], num_groups, shape[-1] // num_groups)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    xn = ((xf - mu) * torch.rsqrt(var + eps)).reshape(shape)
    return (xn * w.to(torch.float32) + b.to(torch.float32)).to(x.dtype)


def l2_normalize_heads(x, H, N):
    """Per-head x / max(||x||, 1e-12)."""
    shape = x.shape
    xf = x.to(torch.float32).reshape(*shape[:-1], H, N)
    out = xf / torch.sqrt((xf * xf).sum(-1, keepdim=True)).clamp_min(1e-12)
    return out.reshape(shape).to(x.dtype)


def _rand_batch(rng, B, T, H):
    C = H * N
    f = lambda *s: (rng.standard_normal(s) * 0.5).astype(np.float32)
    kkn = rng.standard_normal((B, T, H, N))
    kkn = (kkn / np.linalg.norm(kkn, axis=-1, keepdims=True)).reshape(B, T, C)
    iclr = 1 / (1 + np.exp(-rng.standard_normal((B, T, C))))
    return dict(state=(rng.standard_normal((B, N, C)) * 0.3).astype(np.float32),
                r=f(B, T, C), w=f(B, T, C), k=f(B, T, C), v=f(B, T, C),
                a=(-kkn).astype(np.float32), b=(kkn * iclr).astype(np.float32),
                elapsed=rng.integers(0, 2 ** 31 - 1, (B,)).astype(np.int32))


@pytest.mark.parametrize("B,T,H,lengths", [(2, 1, 2, None), (3, 5, 2, (5, 2, 0))])
def test_reference_batch_matches_jax(B, T, H, lengths):
    """float32 on both sides; only the summation order differs (einsum vs
    XLA's), so 1e-5 absolute/relative covers it at these magnitudes."""
    d = _rand_batch(np.random.default_rng(3), B, T, H)
    args = [d[k] for k in ("state", "r", "w", "k", "v", "a", "b", "elapsed")]
    ln = None if lengths is None else np.asarray(lengths, np.int32)
    y_j, s_j = jwkv.wkv7_reference_batch(*(jnp.asarray(a) for a in args),
                                         lengths=None if ln is None else jnp.asarray(ln))
    y_t, s_t = twkv.wkv7_reference_batch(*(torch.from_numpy(a) for a in args),
                                         lengths=None if ln is None else torch.from_numpy(ln))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,H,L,li,lengths", [
    (4, 3, 2, 1, (1, 1, 1, 1)),
    (5, 2, 3, 0, (1, 0, 1, 0, 1)),
])
def test_fused_step_plain_matches_pallas(B, H, L, li, lengths):
    """The port's fused step (plain version on CPU) against
    wkv7_pallas_step_fused(interpret=True). Tolerance 5e-4, as the JAX package's
    own fused-vs-composition test: the Pallas kernel computes y through the
    2-dot algebraic form and its per-head sums as segment matmuls, the port
    directly. Length-0 rows keep their state bit for bit and output 0; every
    other layer of the stacked state stays bit-identical."""
    rng = np.random.default_rng(7 + B)
    C = H * N
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    r, w, k_raw, v = f(B, C), f(B, C), f(B, C), f(B, C)
    a_iclr = (1 / (1 + np.exp(-f(B, C)))).astype(np.float32)
    k_k, k_a, r_k = f(C) * 0.5, f(C) * 0.5, f(C) * 0.5
    lnw, lnb = f(C) * 0.3 + 1.0, f(C) * 0.1
    state = (rng.standard_normal((L, B, N, C)) * 0.2).astype(np.float32)
    elapsed = (np.arange(B) * 7 + 2 ** 31 - 20).astype(np.int32)
    ln = np.asarray(lengths, np.int32)

    v_nh = v.reshape(B, H, N).transpose(0, 2, 1)
    y_j, s_j = wkv7_pallas_step_fused(
        jnp.asarray(state), li, jnp.asarray(r), jnp.asarray(w), jnp.asarray(k_raw),
        jnp.asarray(a_iclr), jnp.asarray(v_nh), jnp.asarray(k_k), jnp.asarray(k_a),
        jnp.asarray(r_k), jnp.asarray(lnw.reshape(H, N).T), jnp.asarray(lnb.reshape(H, N).T),
        jnp.asarray(elapsed), jnp.asarray(ln), interpret=True)
    y_j = np.asarray(y_j).transpose(0, 2, 1).reshape(B, C)   # (B, N, H) -> (B, C)
    s_j = np.asarray(s_j)

    st = torch.from_numpy(state.copy())
    t = torch.from_numpy
    y_t = wkv7_step_fused(st, li, t(r), t(w), t(k_raw), t(a_iclr), t(v), t(k_k), t(k_a),
                          t(r_k), t(lnw), t(lnb), t(elapsed), t(ln)).numpy()
    s_t = st.numpy()

    np.testing.assert_allclose(y_t, y_j, rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(s_t[li], s_j[li], rtol=5e-4, atol=5e-4)
    for other in range(L):
        if other != li:
            np.testing.assert_array_equal(s_t[other], state[other])
    for b in np.flatnonzero(ln == 0):
        np.testing.assert_array_equal(s_t[li, b], state[li, b])
        assert np.all(y_t[b] == 0)


def test_fused_step_matches_unfused_composition():
    """The fused plain step equals the unfused composition the non-decode path
    uses: l2-normalise -> wkv7_reference_batch -> GroupNorm -> bonus (float32,
    reduction order only: 1e-5)."""
    from chirrup_tpu_torch.ops.wkv7_cuda import wkv7_step_fused_reference

    rng = np.random.default_rng(11)
    B, H = 3, 2
    C = H * N
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    r, w, k_raw, v = t(B, C), t(B, C), t(B, C), t(B, C)
    a = torch.sigmoid(t(B, C))
    k_k, k_a, r_k, lnw, lnb = t(C) * 0.5, t(C) * 0.5, t(C) * 0.5, t(C) + 1, t(C) * 0.1
    state = t(B, N, C) * 0.2
    elapsed = torch.tensor([3, 99, 12345], dtype=torch.int32)
    ones = torch.ones(B, dtype=torch.int32)
    y_f, s_f = wkv7_step_fused_reference(state, r, w, k_raw, a, v, k_k, k_a, r_k,
                                         lnw, lnb, elapsed, ones)
    kk = l2_normalize_heads(k_raw * k_k, H, N)
    k_t = k_raw * (1 + (a - 1) * k_a)
    y, s_u = twkv.wkv7_reference_batch(state, r[:, None], w[:, None], k_t[:, None],
                                       v[:, None], -kk[:, None], (kk * a)[:, None], elapsed)
    y = group_norm(y[:, 0], H, lnw, lnb, eps=64e-5)
    y = y + ((r * k_t * r_k).reshape(B, H, N).sum(-1, keepdim=True)
             * v.reshape(B, H, N)).reshape(B, C)
    torch.testing.assert_close(y_f, y, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s_f, s_u, rtol=1e-5, atol=1e-5)
