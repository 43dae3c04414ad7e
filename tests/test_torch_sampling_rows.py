"""The exact draw on flagged rows only (chirrup_tpu_torch/ops/sampling_cuda.py:
sample_exact_rows and its use in sample_from_chunks) against the rwkv-pip
exact sampler and the JAX package's sample_from_chunks.

On the CPU, sample_exact_rows runs its plain version: the flagged rows'
penalized logits through sample_logits_rwkv_pip_compatible, with handed noise
or the noise of the kernel's counter-based generator (philox_gumbel), which
the plain version computes in numpy. Noise is made from numpy seeds and
handed in where two draws are compared token for token; the JAX package's
draws are compared in distribution.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from chirrup_tpu.ops import sampling_pallas as jtail
from chirrup_tpu_torch.ops import sampling as tsamp
from chirrup_tpu_torch.ops.sampling_cuda import (
    CHUNK, penalty_tail_reference, philox4x32, philox_gumbel, sample_exact_rows,
    sample_from_chunks)

V = 64 * CHUNK  # one candidate chunk for each of 64 distinct values


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _gumbel(rng, *shape):
    return _t(rng.gumbel(size=shape).astype(np.float32))


def _candidates(logits):
    """The tail's candidates of rows without penalties."""
    n = logits.shape[0]
    zero = torch.zeros_like(logits)
    _, _, cval, cidx, lse = penalty_tail_reference(
        logits, zero, zero, torch.ones(n), torch.zeros(n), torch.zeros(n),
        torch.full((n,), -1, dtype=torch.int32), torch.zeros(n, dtype=torch.bool),
        torch.ones(n, dtype=torch.bool))
    return cval, cidx, lse, zero


def _mixed_rows(rng, B=8):
    """Rows the candidates cover (one dominant logit; greedy) and rows they do
    not (flat with top_p 1; top_k above k_max), with their parameters."""
    logits = (rng.standard_normal((B, V)) * 0.01).astype(np.float32)
    for r in (0, 2, 5):
        logits[r, 1000 + r] = 40.0  # covered by its top candidate
    temp = np.array([1.0, 1.5, 0.0, 2.0, 1.0, 0.8, 1.0, 1.0], np.float32)[:B]
    top_p = np.array([0.3, 1.0, 0.3, 1.0, 0.9, 0.5, 1.0, 0.7], np.float32)[:B]
    top_k = np.array([0, 0, 0, 0, 200, 0, 0, 300], np.int32)[:B]
    return _t(logits), _t(temp), _t(top_p), _t(top_k)


def _flags(cval, lse, temp, top_p, top_k, k_max):
    """The rows sample_from_chunks sends to the exact draw (its `need`)."""
    top = torch.exp(torch.sort(cval, -1, descending=True).values[:, :k_max] - lse)
    top_p_eff = torch.where(temp == 0, 0.0, top_p)
    return (top.sum(-1) < top_p_eff) | (top_k > k_max)


def test_philox_known_answer():
    """philox4x32 is Philox4x32-10: the Random123 known-answer vector for
    counter 0 and key 0."""
    words = philox4x32(np.zeros(1, np.uint64), (0, 0))[0]
    assert [int(w) for w in words] == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]


def test_philox_gumbel_is_a_function_of_the_seed():
    """The exact kernel's noise for a row depends on its seed alone: the same
    seed gives the same noise, another seed other noise; every value is
    finite and its mean is near the Gumbel mean 0.5772."""
    seeds = torch.tensor([5, 5, 2 ** 40 + 3], dtype=torch.int64)
    g = philox_gumbel(seeds, 4099)
    assert g.shape == (3, 4099) and bool(torch.isfinite(g).all())
    assert torch.equal(g[0], g[1]) and not torch.equal(g[0], g[2])
    assert abs(float(g.mean()) - 0.5772) < 0.05


def test_unflagged_rows_keep_the_candidate_draw():
    """Rows the candidates cover come out bit-equal to the candidate draw
    alone (the same call with no row allowed the exact path), and flagged
    rows equal sample_logits_rwkv_pip_compatible with the same handed noise."""
    rng = np.random.default_rng(1)
    logits, temp, top_p, top_k = _mixed_rows(rng)
    cval, cidx, lse, zero = _candidates(logits)
    g, g_exact = _gumbel(rng, 8, 32), _gumbel(rng, 8, V)
    args = (cval, cidx, lse, temp, top_p, top_k, None, (logits, zero, zero, torch.zeros(8)))
    toks = sample_from_chunks(*args, k_max=32, gumbel=g, gumbel_exact=g_exact)
    fast = sample_from_chunks(*args, row_mask=torch.zeros(8, dtype=torch.bool), k_max=32,
                              gumbel=g, gumbel_exact=g_exact)
    exact = tsamp.sample_logits_rwkv_pip_compatible(logits, temp, top_p, top_k,
                                                    gumbel=g_exact)
    need = _flags(cval, lse, temp, top_p, top_k, 32)
    assert need.tolist() == [False, True, False, True, True, False, True, True]
    assert torch.equal(toks[~need], fast[~need])
    assert torch.equal(toks[need], exact[need])
    assert toks[0] == 1000 and toks[2] == 1002 and toks[5] == 1005


def test_row_mask_is_respected():
    """A flagged row outside row_mask keeps its candidate token; the other
    flagged rows take the exact draw."""
    rng = np.random.default_rng(2)
    logits, temp, top_p, top_k = _mixed_rows(rng)
    cval, cidx, lse, zero = _candidates(logits)
    g, g_exact = _gumbel(rng, 8, 32), _gumbel(rng, 8, V)
    args = (cval, cidx, lse, temp, top_p, top_k, None, (logits, zero, zero, torch.zeros(8)))
    mask = torch.tensor([True, False, True, True, True, True, False, True])
    toks = sample_from_chunks(*args, row_mask=mask, k_max=32, gumbel=g, gumbel_exact=g_exact)
    fast = sample_from_chunks(*args, row_mask=torch.zeros(8, dtype=torch.bool), k_max=32,
                              gumbel=g, gumbel_exact=g_exact)
    exact = tsamp.sample_logits_rwkv_pip_compatible(logits, temp, top_p, top_k,
                                                    gumbel=g_exact)
    for r in (1, 6):  # flagged, masked out
        assert toks[r] == fast[r] and int(toks[r]) in set(cidx[r].tolist())
    for r in (3, 4, 7):
        assert toks[r] == exact[r]


@pytest.mark.parametrize("noise", ["seeds", "gumbel"])
def test_exact_rows_write_only_flagged_rows(noise):
    """sample_exact_rows rebuilds the penalized logits of the flagged rows
    (logits - pres2 - occ2 * freq), draws them with their noise (handed, or
    philox_gumbel of their seeds) and leaves every other row's token as it
    is."""
    rng = np.random.default_rng(3)
    B = 6
    logits = _t((rng.standard_normal((B, V)) * 2).astype(np.float32))
    pres = _t(((rng.random((B, V)) < 0.01) * 0.5).astype(np.float32))
    occ = _t(((rng.random((B, V)) < 0.01) * rng.random((B, V))).astype(np.float32))
    freq = _t(rng.random(B).astype(np.float32))
    temp = _t(np.array([1.0, 0.7, 1.3, 0.0, 1.0, 2.0], np.float32))
    top_p = _t(np.array([0.9, 0.5, 1.0, 0.3, 0.8, 1.0], np.float32))
    top_k = _t(np.array([0, 7, 300, 0, 0, 50], np.int32))
    need = torch.tensor([True, False, True, True, False, True])
    seeds = torch.randint(0, 2 ** 62, (B,), generator=torch.Generator().manual_seed(3))
    gumbel = philox_gumbel(seeds, V) if noise == "seeds" else _gumbel(rng, B, V)
    kw = dict(seeds=seeds) if noise == "seeds" else dict(gumbel=gumbel)
    tokens = torch.full((B,), -5, dtype=torch.int32)
    adj = logits - pres - occ * freq[:, None]
    lse = torch.logsumexp(adj, -1)
    out = sample_exact_rows(tokens, need, logits, pres, occ, freq, lse, temp, top_p, top_k,
                            **kw)
    assert out is tokens
    want = tsamp.sample_logits_rwkv_pip_compatible(adj, temp, top_p, top_k, gumbel=gumbel)
    assert torch.equal(tokens[need], want[need])
    assert bool((tokens[~need] == -5).all())
    with pytest.raises(ValueError, match="exactly one"):
        sample_exact_rows(tokens, need, logits, pres, occ, freq, lse, temp, top_p, top_k)


def _expected(row, temperature, top_p, top_k):
    """The rwkv-pip distribution of one row, in float64 (numpy)."""
    x = row.astype(np.float64)
    p = np.exp(x - x.max())
    p /= p.sum()
    order = np.argsort(-p, kind="stable")
    pos = min(int(np.searchsorted(np.cumsum(p[order]), top_p)), len(p) - 1)
    p = np.where(p < p[order][pos], 0.0, p)
    if top_k > 0:
        p[order[top_k:]] = 0.0
    p = p ** (1.0 / temperature)
    return p / p.sum()


@pytest.mark.parametrize("case", [(1.5, 1.0, 0), (1.0, 1.0, 40)])
def test_hostile_row_matches_the_distribution(case):
    """A hostile row (top_p 1 at a high temperature, or top_k above k_max):
    64 distinct logits at one column per chunk over a flat floor, so the
    k_max = 32 candidates never cover it and every draw takes the exact
    path. 3,000 draws from the port's sample_from_chunks (the generator's
    seeds, the kernel's noise) and 3,000 from the JAX package's
    sample_from_chunks lie within 0.03 of the analytic distribution per
    token and never outside its support."""
    temp, top_p, top_k = case
    rng = np.random.default_rng(7)
    n = 3000
    row = np.full(V, -3.0, np.float32)
    row[np.arange(64) * CHUNK] = (rng.standard_normal(64) * 1.5).astype(np.float32)
    expected = _expected(row, temp, top_p, top_k)
    logits = _t(np.broadcast_to(row, (n, V)).copy())
    cval, cidx, lse, zero = _candidates(logits)
    tp = (torch.full((n,), temp), torch.full((n,), top_p),
          torch.full((n,), top_k, dtype=torch.int32))
    assert bool(_flags(cval, lse, *tp, 32).all())
    port = sample_from_chunks(cval, cidx, lse, *tp, torch.Generator().manual_seed(8),
                              (logits, zero, zero, torch.zeros(n)), k_max=32)
    jargs = [jnp.asarray(a.numpy()) for a in (cval, cidx, lse, *tp)]
    jz = jnp.zeros((n, V), jnp.float32)
    jax_toks = jtail.sample_from_chunks(*jargs, jax.random.PRNGKey(9),
                                        (jnp.asarray(logits.numpy()), jz, jz,
                                         jnp.zeros(n, jnp.float32)), k_max=32)
    for name, toks in (("port", port.numpy()), ("jax", np.asarray(jax_toks))):
        freq = np.bincount(toks, minlength=V) / n
        assert np.abs(freq - expected).max() < 0.03, name
        assert set(np.nonzero(freq)[0]) <= set(np.nonzero(expected)[0]), name
