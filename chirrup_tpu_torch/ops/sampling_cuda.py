"""The fused penalty tail: CUDA kernel (csrc/penalty_tail.cu), its plain
PyTorch version, and the sampler that draws from its candidate set.

One pass over (logits, occurrence, presence) per decode step does the record
of the previous sample, the decay, the penalties, a logsumexp and the
per-128-column maxima that form the candidate set of the sampler:

  occ2  = (occ + onehot(last_tok) * upd) * decay      [decode rows only]
  pres2 = set(last_tok -> presence_penalty)            [upd rows]
  adj   = logits - pres2 - occ2 * freq

The record of step t's sample is deferred to step t+1 through the carried
last_sampled: recording at the end of step t and decaying at the start of t+1
(the reference scheduler's order) gives the same sequence for every token.

The kernel splits each row's vocabulary over the CTAs of a thread-block
cluster, each owning whole 128-column chunks; ``tail_plan`` gives the split.

The sampler draws from the tail's candidates; the rows those cannot serve
exactly take the exact rwkv-pip draw of ``sample_exact_rows`` (CUDA kernel
csrc/sample_exact.cu, one cluster of CTAs a row that returns at once for a
row that is not flagged, and its plain version), so a hostile request costs
only its own row.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from chirrup_tpu_torch.ops import _kernels
from chirrup_tpu_torch.ops.sampling import gumbel_like, sample_logits_rwkv_pip_compatible

CHUNK = 128  # candidate bucket width

_SOURCE = "penalty_tail"
_P, _I = _kernels.P, _kernels.I
_SIGNATURES = {"penalty_tail": [_P] * 12 + [_I] * 7 + [_P]}
MAX_SPLIT = 8  # CTAs a row: the portable thread-block cluster size
_EXACT_SOURCE = "sample_exact"
_EXACT_SIGNATURES = {"sample_exact_rows": [_P] * 13 + [_I] * 5 + [_P]}
# the exact kernel's launch, fixed in csrc/sample_exact.cu: a row on the
# EXACT_SPLIT CTAs of one cluster, EXACT_THREADS threads each
EXACT_THREADS, EXACT_SPLIT = 1024, 4


class TailPlan(NamedTuple):
    """The penalty tail's launch: each row on the `split` CTAs of one
    cluster of `threads` threads; CTA r owns chunks [r * chunks_per_cta,
    min((r + 1) * chunks_per_cta, n_chunks)) of 128 columns, every CTA at
    least one; warp w of a CTA takes `chunks_in_flight` consecutive chunks
    from the CTA's first + w * chunks_in_flight on, then steps by warps *
    chunks_in_flight; grid and cluster as launched (1-D, `split` CTAs a
    row). The wrapper hands the plan to the kernel's entry, which refuses
    threads or chunks in flight other than its own."""
    split: int
    threads: int
    chunks_per_cta: int
    chunks_in_flight: int
    grid: Tuple[int, int, int]
    cluster: Tuple[int, int, int]


def tail_shape(B: int, V: int, split: int) -> TailPlan:
    """The penalty tail's launch for B rows of V columns with a row on up to
    `split` CTAs (never more than the row has chunks, and none without one)
    of 256 threads each, 4 chunks in flight a warp: any split of 1 to 8
    gives the same results. Raises ValueError for shapes or splits the
    kernel does not take."""
    if B < 1 or V < 1 or V >= 2 ** 31 - CHUNK or B * MAX_SPLIT >= 2 ** 31:
        raise ValueError(f"penalty_tail: unsupported shapes B {B}, V {V}")
    if not 1 <= split <= MAX_SPLIT:
        raise ValueError(f"penalty_tail: a row splits over 1 to {MAX_SPLIT} CTAs, not {split}")
    n_chunks = -(-V // CHUNK)
    per_cta = -(-n_chunks // min(split, n_chunks))
    split = -(-n_chunks // per_cta)  # no CTA without a chunk
    return TailPlan(split=split, threads=256, chunks_per_cta=per_cta, chunks_in_flight=4,
                    grid=(split * B, 1, 1), cluster=(split, 1, 1))


def tail_plan(B: int, V: int) -> TailPlan:
    """The penalty tail's launch for B rows of V columns: above batch 128 a
    row on one CTA; up to 128, the largest power of two of CTAs a row that
    keeps B times it at most 128 (one CTA an SM), but 2 to 8. On the H100,
    at V 65536, that was the fastest split of 1, 2, 4 and 8 at each batch
    timed: 1, 8, 32, 64, 128, 256 and 512 (chip_smoke.py, tail_splits_ms;
    PERF.md). Raises ValueError for shapes the kernel does not take."""
    if B > 128:
        return tail_shape(B, V, 1)
    return tail_shape(B, V, min(MAX_SPLIT, max(2, 1 << ((128 // max(B, 1)).bit_length() - 1))))


def penalty_tail_reference(logits, occurrence, presence_vec, penalty_decay,
                           frequency_penalty, presence_penalty, last_tok, upd_mask,
                           decode_mask):
    """Plain version, without side effects. logits (B, V); occurrence,
    presence_vec (B, V) float32; penalty_decay, frequency_penalty,
    presence_penalty (B,) float32; last_tok (B,) int32 (-1 = none); upd_mask,
    decode_mask (B,) bool. Returns (occ2, pres2, chunk_val (B, NC) float32,
    chunk_idx (B, NC) int32, lse (B, 1) float32), NC = ceil(V / 128)."""
    B, V = logits.shape
    f32 = torch.float32
    lane = torch.arange(V, device=logits.device)[None, :]
    hit = (lane == last_tok.reshape(B, 1)) & upd_mask.reshape(B, 1)
    occ2 = torch.where(decode_mask.reshape(B, 1),
                       (occurrence + hit.to(f32)) * penalty_decay.reshape(B, 1),
                       occurrence)
    pres2 = torch.where(hit, presence_penalty.reshape(B, 1), presence_vec)
    adj = logits.to(f32) - pres2 - occ2 * frequency_penalty.reshape(B, 1)
    n_chunks = -(-V // CHUNK)
    pad = n_chunks * CHUNK - V
    adj3 = torch.nn.functional.pad(adj, (0, pad), value=-float("inf"))
    adj3 = adj3.reshape(B, n_chunks, CHUNK)
    cval = adj3.amax(dim=-1)
    arg = adj3.argmax(dim=-1)  # the first maximal column on ties
    cidx = (arg + torch.arange(n_chunks, device=logits.device)[None, :] * CHUNK)
    lse = torch.logsumexp(adj, dim=-1, keepdim=True)
    return occ2, pres2, cval, cidx.to(torch.int32), lse


def penalty_tail(logits, occurrence, presence_vec, penalty_decay, frequency_penalty,
                 presence_penalty, last_tok, upd_mask, decode_mask):
    """See penalty_tail_reference; occurrence and presence_vec are updated IN
    PLACE and returned. The kernel (launched as tail_plan says) on CUDA
    tensors, the plain version on CPU."""
    if logits.device.type == "cpu":
        occ2, pres2, cval, cidx, lse = penalty_tail_reference(
            logits, occurrence, presence_vec, penalty_decay, frequency_penalty,
            presence_penalty, last_tok, upd_mask, decode_mask)
        occurrence.copy_(occ2)
        presence_vec.copy_(pres2)
        return occurrence, presence_vec, cval, cidx, lse
    return penalty_tail_planned(None, logits, occurrence, presence_vec, penalty_decay,
                                frequency_penalty, presence_penalty, last_tok, upd_mask,
                                decode_mask)


def penalty_tail_planned(plan: Optional[TailPlan], logits, occurrence, presence_vec,
                         penalty_decay, frequency_penalty, presence_penalty, last_tok,
                         upd_mask, decode_mask):
    """penalty_tail's kernel on CUDA tensors with a given launch
    (tail_shape), or tail_plan's when `plan` is None: any launch gives the
    same occ, pres, cval and cidx, and lse within its reordering bound."""
    if not logits.is_cuda:
        raise ValueError(f"penalty_tail: no kernel for device {logits.device}")
    B, V = logits.shape
    dev = logits.device
    _kernels.require(logits, "logits", device=dev)
    code = _kernels.dtype_code(logits, "logits")
    for name, t in (("occurrence", occurrence), ("presence_vec", presence_vec)):
        _kernels.require(t, name, dtype=torch.float32, shape=(B, V), device=dev)
    for name, t in (("penalty_decay", penalty_decay),
                    ("frequency_penalty", frequency_penalty),
                    ("presence_penalty", presence_penalty)):
        _kernels.require(t, name, dtype=torch.float32, shape=(B,), device=dev)
    _kernels.require(last_tok, "last_tok", dtype=torch.int32, shape=(B,), device=dev)
    for name, t in (("upd_mask", upd_mask), ("decode_mask", decode_mask)):
        _kernels.require(t, name, dtype=torch.bool, shape=(B,), device=dev)
    if plan is None:
        plan = tail_plan(B, V)
    n_chunks = -(-V // CHUNK)
    cval = torch.empty((B, n_chunks), dtype=torch.float32, device=dev)
    cidx = torch.empty((B, n_chunks), dtype=torch.int32, device=dev)
    lse = torch.empty((B, 1), dtype=torch.float32, device=dev)
    lib = _kernels.library(_SOURCE, _SIGNATURES)
    err = lib.penalty_tail(
        logits.data_ptr(), occurrence.data_ptr(), presence_vec.data_ptr(),
        penalty_decay.data_ptr(), frequency_penalty.data_ptr(),
        presence_penalty.data_ptr(), last_tok.data_ptr(), upd_mask.data_ptr(),
        decode_mask.data_ptr(), cval.data_ptr(), cidx.data_ptr(), lse.data_ptr(),
        B, V, code, plan.split, plan.chunks_per_cta, plan.threads, plan.chunks_in_flight,
        _kernels.stream_of(logits))
    _kernels.count_launch("penalty_tail")
    _kernels.check(lib, _SOURCE, "penalty_tail", err)
    return occurrence, presence_vec, cval, cidx, lse


_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = np.uint64(0xFFFFFFFF)


def philox4x32(counter: np.ndarray, key: Tuple[int, int]) -> np.ndarray:
    """Philox4x32-10 (Salmon et al., SC'11) of counters (c, 0, 0, 0), c an
    array of uint32, under one 64-bit key (k0, k1): (..., 4) uint32. The
    generator csrc/sample_exact.cu runs inside the kernel."""
    x = [np.asarray(counter, np.uint64) & _U32] + [np.zeros(np.shape(counter), np.uint64)] * 3
    k0, k1 = np.uint64(key[0]), np.uint64(key[1])
    m0, m1 = np.uint64(_PHILOX_M[0]), np.uint64(_PHILOX_M[1])
    for _ in range(10):
        p0, p1 = m0 * x[0], m1 * x[2]  # exact: both factors < 2^32
        x = [(p1 >> np.uint64(32)) ^ x[1] ^ k0, p1 & _U32,
             (p0 >> np.uint64(32)) ^ x[3] ^ k1, p0 & _U32]
        k0 = (k0 + np.uint64(_PHILOX_W[0])) & _U32
        k1 = (k1 + np.uint64(_PHILOX_W[1])) & _U32
    return np.stack(x, axis=-1).astype(np.uint32)


def philox_gumbel(seeds: torch.Tensor, V: int) -> torch.Tensor:
    """The exact kernel's Gumbel noise for rows with these int64 seeds: (n,
    V) float32. Column v takes word v % 4 of Philox4x32-10 at counter v // 4
    under key (seed mod 2^32, seed >> 32); u = (x >> 9 + 0.5) 2^-23 (exact
    in float32, inside (0, 1)), g = -log(-log(u)), in float32."""
    out = np.empty((seeds.numel(), V), np.float32)
    counters = np.arange(-(-V // 4), dtype=np.uint64)
    for i, seed in enumerate(seeds.reshape(-1).tolist()):
        seed &= 2 ** 64 - 1
        words = philox4x32(counters, (seed & 0xFFFFFFFF, seed >> 32)).reshape(-1)[:V]
        u = ((words >> 9).astype(np.float32) + np.float32(0.5)) * np.float32(2.0 ** -23)
        out[i] = -np.log(-np.log(u))
    return torch.from_numpy(out)


def sample_exact_rows_reference(tokens, need, logits, pres2, occ2, freq, lse, temperature,
                                top_p, top_k, *, seeds=None, gumbel=None):
    """Plain version of sample_exact_rows: the flagged rows' penalized logits
    (adj = logits - pres2 - occ2 * freq, the tail's order) through
    sample_logits_rwkv_pip_compatible with the rows' noise, gumbel's rows or
    philox_gumbel of their seeds; tokens is written at those rows, IN PLACE,
    and returned. It reads the flags on the host (the kernel never does).
    lse is the kernel's input only (the softmax here recomputes it)."""
    rows = torch.nonzero(need.reshape(-1)).reshape(-1)
    if rows.numel() == 0:
        return tokens
    V = logits.shape[1]
    adj = (logits[rows].to(torch.float32) - pres2[rows]
           - occ2[rows] * freq.reshape(-1)[rows].reshape(-1, 1))
    if gumbel is not None:
        noise = gumbel[rows]
    else:
        noise = philox_gumbel(seeds.reshape(-1)[rows].cpu(), V).to(logits.device)
    drawn = sample_logits_rwkv_pip_compatible(
        adj, temperature.reshape(-1)[rows], top_p.reshape(-1)[rows],
        top_k.reshape(-1)[rows], gumbel=noise)
    tokens[rows] = drawn.to(tokens.dtype)
    return tokens


def sample_exact_rows(tokens, need, logits, pres2, occ2, freq, lse, temperature, top_p, top_k,
                      *, seeds=None, gumbel=None):
    """The exact rwkv-pip draw for the rows where `need` (B,) bool is true,
    written into tokens (B,) int32 IN PLACE (returned); other rows keep
    their tokens. logits (B, V) float32 or bfloat16 (raw, before the
    penalties); pres2, occ2 (B, V) float32 (the tail's outputs); freq,
    temperature, top_p (B,) float32; top_k (B,) int32; lse (B,) or (B, 1)
    float32, the tail's logsumexp of the penalized row. Noise: gumbel (B, V)
    float32, or seeds (B,) int64 for the generator inside the kernel
    (philox_gumbel). The kernel on CUDA tensors (one launch whatever the
    flags), the plain version on CPU."""
    if (seeds is None) == (gumbel is None):
        raise ValueError("sample_exact_rows: give exactly one of seeds and gumbel")
    if logits.device.type == "cpu":
        return sample_exact_rows_reference(tokens, need, logits, pres2, occ2, freq, lse,
                                           temperature, top_p, top_k, seeds=seeds,
                                           gumbel=gumbel)
    if not logits.is_cuda:
        raise ValueError(f"sample_exact_rows: no kernel for device {logits.device}")
    B, V = logits.shape
    dev = logits.device
    _kernels.require(logits, "logits", device=dev)
    code = _kernels.dtype_code(logits, "logits")
    for name, t in (("pres2", pres2), ("occ2", occ2)):
        _kernels.require(t, name, dtype=torch.float32, shape=(B, V), device=dev)
    lse = lse.reshape(-1)
    for name, t in (("freq", freq), ("lse", lse), ("temperature", temperature),
                    ("top_p", top_p)):
        _kernels.require(t, name, dtype=torch.float32, shape=(B,), device=dev)
    _kernels.require(top_k, "top_k", dtype=torch.int32, shape=(B,), device=dev)
    _kernels.require(need, "need", dtype=torch.bool, shape=(B,), device=dev)
    _kernels.require(tokens, "tokens", dtype=torch.int32, shape=(B,), device=dev)
    if gumbel is not None:
        _kernels.require(gumbel, "gumbel", dtype=torch.float32, shape=(B, V), device=dev)
    else:
        _kernels.require(seeds, "seeds", dtype=torch.int64, shape=(B,), device=dev)
    scratch = torch.empty((B, V), dtype=torch.float32, device=dev)
    lib = _kernels.library(_EXACT_SOURCE, _EXACT_SIGNATURES)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = lib.sample_exact_rows(
        logits.data_ptr(), pres2.data_ptr(), occ2.data_ptr(), freq.data_ptr(), lse.data_ptr(),
        temperature.data_ptr(), top_p.data_ptr(), top_k.data_ptr(), need.data_ptr(),
        ptr(gumbel), ptr(seeds), scratch.data_ptr(), tokens.data_ptr(), B, V, code,
        EXACT_THREADS, EXACT_SPLIT, _kernels.stream_of(logits))
    _kernels.count_launch("sample_exact_rows")
    _kernels.check(lib, _EXACT_SOURCE, "sample_exact_rows", err)
    return tokens


def sample_from_chunks(chunk_val, chunk_idx, lse, temperature, top_p, top_k,
                       generator: Optional[torch.Generator], adj_args, row_mask=None,
                       k_max: int = 128, gumbel=None, gumbel_exact=None, seeds=None):
    """rwkv-pip-compatible draw from the penalty_tail candidate set.

    Same algorithm and order as ops.sampling.sample_logits_rwkv_pip_fast, with
    the candidates = the per-chunk maxima (already penalized). Rows whose
    candidates do not cover top_p (or whose top_k > k_max) are flagged, and
    sample_exact_rows redraws exactly those from their penalized logits,
    rebuilt from adj_args = (logits, pres2, occ2, freq): on CUDA one launch
    that does work for flagged rows only, so the flags are never read on the
    host, as the JAX package's lax.cond and while_loop over 8-row windows of
    flagged rows keep its count on the device.

    Noise: gumbel (B, k_max') for the candidate draw, and for the exact
    draw gumbel_exact (B, V) or seeds (B,) int64 (the kernel's generator),
    each handed in or drawn from `generator`."""
    logits_raw, pres2, occ2, freq = adj_args
    B, NC = chunk_val.shape
    k_max = min(k_max, NC)
    temp_rows = temperature.reshape(B).to(torch.float32)
    top_p_rows = top_p.reshape(B).to(torch.float32)
    top_k_rows = top_k.reshape(B).to(torch.int32)
    temperature, top_p, top_k = (temp_rows.reshape(B, 1), top_p_rows.reshape(B, 1),
                                 top_k_rows.reshape(B, 1))

    zero_temp = temperature == 0.0
    temperature_eff = torch.where(zero_temp, 1.0, temperature)
    top_p_eff = torch.where(zero_temp, 0.0, top_p)

    # stable descending sort keeps equal values in chunk order (lower token id first)
    sorted_val, order = torch.sort(chunk_val, dim=-1, descending=True, stable=True)
    top_lg = sorted_val[:, :k_max]
    top_idx = torch.gather(chunk_idx, 1, order[:, :k_max])
    top_vals = torch.exp(top_lg - lse)
    cum = torch.cumsum(top_vals, dim=-1)

    covered = cum[:, -1:] >= top_p_eff
    k_ok = top_k <= k_max
    need = ~covered | ~k_ok
    if row_mask is not None:
        need = need & row_mask.reshape(B, 1)

    cutoff_pos = (cum < top_p_eff).sum(-1, keepdim=True).clamp(0, k_max - 1)
    cutoff_val = torch.gather(top_vals, 1, cutoff_pos)
    vals = torch.where(top_vals < cutoff_val, 0.0, top_vals)
    ranks = torch.arange(k_max, device=chunk_val.device)[None, :]
    eff_k = torch.where(top_k > 0, top_k, k_max)
    vals = torch.where(ranks >= eff_k, 0.0, vals)
    logp = torch.where(vals > 0, torch.log(vals) / temperature_eff, -float("inf"))
    if gumbel is None:
        gumbel = gumbel_like(logp, generator)
    choice = torch.argmax(logp + gumbel[:, :k_max], dim=-1, keepdim=True)
    picked = torch.gather(top_idx, 1, choice)[:, 0]
    # temp=0 greedy: the global argmax is the max of the chunk maxima — exact
    greedy = torch.gather(chunk_idx, 1, torch.argmax(chunk_val, dim=-1, keepdim=True))[:, 0]
    fast = torch.where(zero_temp[:, 0], greedy, picked).to(torch.int32)

    if gumbel_exact is None and seeds is None:
        seeds = torch.randint(0, 2 ** 62, (B,), dtype=torch.int64, generator=generator,
                              device=chunk_val.device)
    return sample_exact_rows(fast, need[:, 0].contiguous(), logits_raw, pres2, occ2,
                             freq.reshape(B).to(torch.float32), lse, temp_rows, top_p_rows,
                             top_k_rows, seeds=None if gumbel_exact is not None else seeds,
                             gumbel=gumbel_exact)
