"""Batched sampling, rwkv-pip-compatible, in PyTorch on the model's device.

Algorithm order (the rwkv pip package's PIPELINE.sample_logits, batched):

  1. temperature == 0  ->  temperature = 1, top_p = 0 (greedy mode)
  2. probs = softmax(logits)            (NO pre-temperature scaling)
  3. top-p by cutoff VALUE: the prob at the first position where the sorted cumsum
     reaches top_p; everything below that value is zeroed
  4. top-k by sorted position, scattered back to vocab order
  5. probs = probs ** (1/T)             (temperature applied AFTER filtering)
  6. renormalize + categorical draw

The draw is Gumbel-max on log-probs, an exact multinomial draw with no host
round trip. Noise comes from an explicit torch.Generator, or is handed in (tests
hand both this and the JAX package the same numpy noise).
"""

from __future__ import annotations

from typing import Optional

import torch


def gumbel_like(x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Standard Gumbel noise shaped like x: -log(E), E ~ Exp(1)."""
    e = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    return -torch.log(e.exponential_(generator=generator))


def sample_logits_rwkv_pip_compatible(logits, temperature, top_p, top_k,
                                      generator: Optional[torch.Generator] = None, *,
                                      gumbel=None):
    """logits: (B, V); temperature/top_p: (B,) float; top_k: (B,) int.
    Returns (B,) int32 sampled token ids."""
    B, V = logits.shape
    logits = logits.to(torch.float32)
    temperature = temperature.reshape(B, 1).to(torch.float32)
    top_p = top_p.reshape(B, 1).to(torch.float32)
    top_k = top_k.reshape(B, 1).to(torch.int64)

    zero_temp = temperature == 0.0
    temperature = torch.where(zero_temp, 1.0, temperature)
    top_p = torch.where(zero_temp, 0.0, top_p)

    probs = torch.softmax(logits, dim=-1)
    sorted_probs, sorted_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    cum = torch.cumsum(sorted_probs, dim=-1)

    # first position where cum >= top_p (torch.searchsorted semantics)
    cutoff_pos = (cum < top_p).sum(-1, keepdim=True).clamp(0, V - 1)
    cutoff_val = torch.gather(sorted_probs, 1, cutoff_pos)
    probs = torch.where(probs < cutoff_val, 0.0, probs)

    # top-k in sorted space, scattered back to vocab order
    ranks = torch.arange(V, device=logits.device)[None, :]
    eff_k = torch.where(top_k > 0, top_k, V)
    outside = torch.zeros((B, V), dtype=torch.bool, device=logits.device)
    outside.scatter_(1, sorted_idx, ranks >= eff_k)
    probs = torch.where(outside, 0.0, probs)

    logp = torch.where(probs > 0, torch.log(probs) / temperature, -float("inf"))
    if gumbel is None:
        gumbel = gumbel_like(logp, generator)
    return torch.argmax(logp + gumbel, dim=-1).to(torch.int32)


def sample_logits_rwkv_pip_fast(logits, temperature, top_p, top_k,
                                generator: Optional[torch.Generator] = None,
                                row_mask=None, k_max: int = 1024, *, gumbel=None,
                                gumbel_exact=None):
    """The same distribution as sample_logits_rwkv_pip_compatible, computed on
    the exact top-k_max logits instead of a full sort.

    Rows whose top-k_max mass does not reach top_p, or whose top_k exceeds
    k_max, take the exact sampler's token. Every row runs the exact sampler and
    torch.where keeps it only for those rows, so the host never reads which rows
    needed it (one (B, V) sort per call). row_mask: rows being sampled (others
    never count as needing the exact path)."""
    B, V = logits.shape
    k_max = min(k_max, V)
    logits = logits.to(torch.float32)
    temperature = temperature.reshape(B, 1).to(torch.float32)
    top_p = top_p.reshape(B, 1).to(torch.float32)
    top_k = top_k.reshape(B, 1).to(torch.int64)

    zero_temp = temperature == 0.0
    temperature_eff = torch.where(zero_temp, 1.0, temperature)
    top_p_eff = torch.where(zero_temp, 0.0, top_p)

    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    top_lg, top_idx = torch.topk(logits, k_max, dim=-1, sorted=True)
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
    ranks = torch.arange(k_max, device=logits.device)[None, :]
    eff_k = torch.where(top_k > 0, top_k, k_max)
    vals = torch.where(ranks >= eff_k, 0.0, vals)
    logp = torch.where(vals > 0, torch.log(vals) / temperature_eff, -float("inf"))
    if gumbel is None:
        gumbel = gumbel_like(logp, generator)
    choice = torch.argmax(logp + gumbel[:, :k_max], dim=-1, keepdim=True)
    picked = torch.gather(top_idx, 1, choice)[:, 0]
    greedy = torch.argmax(logits, dim=-1)  # temp=0 rows: exact argmax
    fast = torch.where(zero_temp[:, 0], greedy, picked).to(torch.int32)

    exact = sample_logits_rwkv_pip_compatible(
        logits, temperature[:, 0], top_p[:, 0], top_k[:, 0], generator,
        gumbel=gumbel_exact)
    return torch.where(need[:, 0], exact, fast)


def apply_penalties(logits, occurrence, presence_vec, frequency_penalty):
    """logits - (presence_vec + occurrence * frequency_penalty). Shapes:
    logits/occurrence/presence (B, V), frequency_penalty (B,)."""
    return logits - (presence_vec + occurrence * frequency_penalty[:, None])


def record_sampled_token(occurrence, presence_vec, tokens, presence_penalty,
                         update_mask):
    """Record freshly sampled tokens into the penalty state:

      occurrence[b, tokens[b]] += 1                      where update_mask
      presence_vec[b, tokens[b]] = presence_penalty[b]   where update_mask

    The occurrence decays at forward time (before the logit subtraction) and the
    sampled token is added afterwards, so a new token is decayed once before it
    first penalizes; callers multiply by penalty_decay themselves.
    Returns new (occurrence, presence_vec)."""
    B, V = occurrence.shape
    onehot = torch.nn.functional.one_hot(tokens.long(), V).to(occurrence.dtype) \
        * update_mask[:, None].to(occurrence.dtype)
    occurrence = occurrence + onehot
    presence_vec = torch.where(onehot > 0, presence_penalty[:, None], presence_vec)
    return occurrence, presence_vec
