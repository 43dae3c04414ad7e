"""chirrup_tpu_torch sampling (ops/sampling.py, ops/sampling_cuda.py) against the
JAX package.

The penalty tail's plain version is held against the JAX tail (its XLA
reference and its Pallas kernel in interpret mode). The samplers draw with
Gumbel noise that the tests make with numpy and hand in, so the port's draws
are reproducible here; distributions are checked against an independent numpy
statement of the rwkv-pip sampling rule, as tests/test_sampling.py does for the
JAX sampler.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from chirrup_tpu.ops import sampling as jsamp
from chirrup_tpu.ops import sampling_pallas as jtail
from chirrup_tpu_torch.ops import sampling as tsamp
from chirrup_tpu_torch.ops.sampling_cuda import (
    CHUNK, penalty_tail, penalty_tail_reference, sample_from_chunks)

V_TAIL = 16384  # the smallest vocab the JAX Pallas tail takes


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _gumbel(rng, *shape):
    return _t(rng.gumbel(size=shape).astype(np.float32))


def _expected_probs_np(logits, temperature, top_p, top_k):
    """Independent numpy statement of the rwkv-pip sampling distribution."""
    if temperature == 0:
        temperature, top_p = 1.0, 0.0
    x = logits - logits.max()
    probs = np.exp(x) / np.exp(x).sum()
    order = np.argsort(-probs, kind="stable")
    sp = probs[order]
    pos = min(int(np.searchsorted(np.cumsum(sp), top_p)), len(sp) - 1)
    probs = np.where(probs < sp[pos], 0.0, probs)
    if top_k > 0:
        probs[order[top_k:]] = 0.0
    probs = probs ** (1.0 / temperature)
    return probs / probs.sum()


def _tail_inputs(rng, B, V):
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    occ = ((rng.random((B, V)) < 0.001) * rng.random((B, V))).astype(np.float32)
    pres = ((rng.random((B, V)) < 0.001) * 0.5).astype(np.float32)
    decay = rng.uniform(0.99, 1.0, (B,)).astype(np.float32)
    freq = rng.uniform(0.0, 1.0, (B,)).astype(np.float32)
    pp = rng.uniform(0.0, 1.0, (B,)).astype(np.float32)
    last = rng.integers(-1, V, (B,)).astype(np.int32)
    dec = rng.random((B,)) < 0.8
    dec[0] = False  # one row that keeps its penalty state
    upd = (rng.random((B,)) < 0.7) & (last >= 0) & dec
    # a tie inside one chunk: the lowest column must win
    c = min(5, V // CHUNK - 1) * CHUNK
    for col in (c + 3, c + 90):
        logits[1, col], occ[1, col], pres[1, col] = 50.0, 0.0, 0.0
    return logits, occ, pres, decay, freq, pp, last, upd, dec


@pytest.mark.parametrize("jax_side", ["reference", "pallas_interpret"])
def test_penalty_tail_plain_matches_jax(jax_side):
    """Penalty state, candidates and logsumexp of the port's plain tail against
    the JAX tail. The elementwise record/decay/penalty and the chunk maxima
    are the same float32 operations in the same order: pres2, occ2, cval and
    cidx are bit-equal. The logsumexp sums 16384 exponentials in another
    order: 1e-5."""
    B = 6
    args = _tail_inputs(np.random.default_rng(0), B, V_TAIL)
    fn = (jtail.penalty_tail_reference if jax_side == "reference"
          else lambda *a: jtail.penalty_tail(*a, interpret=True))
    want = [np.asarray(x) for x in fn(*(jnp.asarray(a) for a in args))]
    occ, pres = _t(args[1].copy()), _t(args[2].copy())
    got = penalty_tail(_t(args[0]), occ, pres, *(_t(a) for a in args[3:]))
    got = [x.numpy() for x in got]
    for name, g, w in zip(("occ2", "pres2", "cval", "cidx"), got[:4], want[:4]):
        np.testing.assert_array_equal(g, w, name)
    np.testing.assert_allclose(got[4], want[4], rtol=1e-5, atol=1e-5)
    assert got[3][1, 5] == 5 * CHUNK + 3
    np.testing.assert_array_equal(got[0][0], args[1][0])  # non-decode row kept


def test_penalty_tail_ragged_vocab():
    """A vocab that is no multiple of 128 (the JAX kernel does not take one;
    the port's does): the plain version's last chunk covers only the real
    columns and equals a dense numpy statement of the same math."""
    rng = np.random.default_rng(1)
    B, V = 3, 300
    args = _tail_inputs(rng, B, V)
    occ2, pres2, cval, cidx, lse = penalty_tail_reference(*(_t(a) for a in args))
    adj = args[0] - pres2.numpy() - occ2.numpy() * args[4][:, None]
    assert cval.shape == (B, 3)
    for c in range(3):
        part = adj[:, c * CHUNK:(c + 1) * CHUNK]
        np.testing.assert_array_equal(cval[:, c].numpy(), part.max(-1))
        np.testing.assert_array_equal(cidx[:, c].numpy(), part.argmax(-1) + c * CHUNK)
    m = adj.max(-1, keepdims=True)
    np.testing.assert_allclose(lse.numpy(), m + np.log(np.exp(adj - m).sum(-1, keepdims=True)),
                               rtol=1e-6, atol=1e-6)


def test_penalty_helpers_match_jax():
    """apply_penalties and record_sampled_token: the same float32 elementwise
    operations on both sides, so exact."""
    rng = np.random.default_rng(2)
    B, V = 4, 64
    logits, occ, pres = (rng.standard_normal((B, V)).astype(np.float32) for _ in range(3))
    freq, pp = rng.random(B).astype(np.float32), rng.random(B).astype(np.float32)
    toks = np.array([3, 5, 63, 0], np.int32)
    upd = np.array([True, False, True, True])
    np.testing.assert_array_equal(
        tsamp.apply_penalties(_t(logits), _t(occ), _t(pres), _t(freq)).numpy(),
        np.asarray(jsamp.apply_penalties(jnp.asarray(logits), jnp.asarray(occ),
                                         jnp.asarray(pres), jnp.asarray(freq))))
    got = tsamp.record_sampled_token(_t(occ), _t(pres), _t(toks), _t(pp), _t(upd))
    want = jsamp.record_sampled_token(jnp.asarray(occ), jnp.asarray(pres),
                                      jnp.asarray(toks), jnp.asarray(pp), jnp.asarray(upd))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_greedy_rows_exact():
    """temperature 0 is argmax on every sampler, whatever the noise."""
    rng = np.random.default_rng(3)
    B, V = 8, 1000
    logits = _t(rng.standard_normal((B, V)).astype(np.float32))
    zeros, top_p, top_k = torch.zeros(B), torch.full((B,), 0.9), torch.zeros(B, dtype=torch.int32)
    want = logits.argmax(-1).numpy()
    exact = tsamp.sample_logits_rwkv_pip_compatible(logits, zeros, top_p, top_k,
                                                    gumbel=_gumbel(rng, B, V))
    fast = tsamp.sample_logits_rwkv_pip_fast(logits, zeros, top_p, top_k, k_max=128,
                                             gumbel=_gumbel(rng, B, 128),
                                             gumbel_exact=_gumbel(rng, B, V))
    np.testing.assert_array_equal(exact.numpy(), want)
    np.testing.assert_array_equal(fast.numpy(), want)


def test_chunk_candidates_greedy_exact():
    """Greedy rows drawn from the tail's candidates equal the dense argmax of
    the penalized logits (a global maximum is the largest chunk maximum)."""
    rng = np.random.default_rng(4)
    B = 4
    args = [_t(a) for a in _tail_inputs(rng, B, V_TAIL)]
    occ2, pres2, cval, cidx, lse = penalty_tail_reference(*args)
    adj = args[0] - pres2 - occ2 * args[4][:, None]
    toks = sample_from_chunks(cval, cidx, lse, torch.zeros(B), torch.full((B,), 0.3),
                              torch.zeros(B, dtype=torch.int32), None,
                              (args[0], pres2, occ2, args[4]),
                              gumbel=_gumbel(rng, B, 128),
                              gumbel_exact=_gumbel(rng, B, V_TAIL))
    np.testing.assert_array_equal(toks.numpy(), adj.argmax(-1).numpy())


@pytest.mark.parametrize("sampler", ["exact", "fast", "chunks"])
def test_distribution_matches_rwkv_pip_rule(sampler):
    """5000 draws per case; per-token frequency within 0.03 of the analytic
    filtered distribution and never outside its support (the tolerance of
    tests/test_sampling.py). The chunk sampler gets one candidate per
    128-column chunk, so its logits put the distinct values in distinct
    chunks."""
    rng = np.random.default_rng(5)
    n, V = 5000, 64 * (CHUNK if sampler == "chunks" else 1)
    row = np.full(V, -30.0, np.float32)
    cols = np.arange(64) * (CHUNK if sampler == "chunks" else 1)
    row[cols] = (rng.standard_normal(64) * 2).astype(np.float32)
    cases = [(1.0, 0.3, 0), (0.8, 0.9, 0), (1.5, 1.0, 10), (1.0, 0.5, 5)]
    for temp, top_p, top_k in cases:
        expected = _expected_probs_np(row.astype(np.float64), temp, top_p, top_k)
        logits = _t(np.broadcast_to(row, (n, V)).copy())
        tp = (torch.full((n,), temp), torch.full((n,), top_p),
              torch.full((n,), top_k, dtype=torch.int32))
        if sampler == "exact":
            toks = tsamp.sample_logits_rwkv_pip_compatible(logits, *tp,
                                                           gumbel=_gumbel(rng, n, V))
        elif sampler == "fast":
            toks = tsamp.sample_logits_rwkv_pip_fast(
                logits, *tp, k_max=32, gumbel=_gumbel(rng, n, 32),
                gumbel_exact=_gumbel(rng, n, V))
        else:
            zero = torch.zeros((n, V))
            _, _, cval, cidx, lse = penalty_tail_reference(
                logits, zero, zero, torch.ones(n), torch.zeros(n), torch.zeros(n),
                torch.full((n,), -1, dtype=torch.int32), torch.zeros(n, dtype=torch.bool),
                torch.ones(n, dtype=torch.bool))
            toks = sample_from_chunks(cval, cidx, lse, *tp, None,
                                      (logits, zero, zero, torch.zeros(n)), k_max=32,
                                      gumbel=_gumbel(rng, n, 32),
                                      gumbel_exact=_gumbel(rng, n, V))
        freq = np.bincount(toks.numpy(), minlength=V) / n
        assert np.abs(freq - expected).max() < 0.03, (sampler, temp, top_p, top_k)
        assert set(np.nonzero(freq)[0]) <= set(np.nonzero(expected)[0])


def test_uncovered_rows_take_the_exact_draw():
    """Rows whose candidates do not reach top_p (top_p = 1 on a flat row) take
    the exact sampler's token drawn with the exact noise; covered rows keep
    the candidate draw; a row outside row_mask is never resampled."""
    rng = np.random.default_rng(6)
    B, V = 4, V_TAIL
    logits_np = (rng.standard_normal((B, V)) * 0.01).astype(np.float32)
    logits_np[1, 777] = 40.0  # row 1 is covered by its top candidate
    logits = _t(logits_np)
    zero = torch.zeros((B, V))
    _, _, cval, cidx, lse = penalty_tail_reference(
        logits, zero, zero, torch.ones(B), torch.zeros(B), torch.zeros(B),
        torch.full((B,), -1, dtype=torch.int32), torch.zeros(B, dtype=torch.bool),
        torch.ones(B, dtype=torch.bool))
    temp, top_p = torch.ones(B), torch.tensor([1.0, 0.3, 1.0, 1.0])
    top_k = torch.zeros(B, dtype=torch.int32)
    g_exact = _gumbel(rng, B, V)
    row_mask = torch.tensor([True, True, True, False])
    toks = sample_from_chunks(cval, cidx, lse, temp, top_p, top_k, None,
                              (logits, zero, zero, torch.zeros(B)), row_mask=row_mask,
                              gumbel=_gumbel(rng, B, 128), gumbel_exact=g_exact)
    exact = tsamp.sample_logits_rwkv_pip_compatible(logits, temp, top_p, top_k,
                                                    gumbel=g_exact)
    assert toks[0] == exact[0] and toks[2] == exact[2]
    assert toks[1] == 777
    assert int(toks[3]) in set(cidx[3].tolist())  # masked row: candidate draw kept
