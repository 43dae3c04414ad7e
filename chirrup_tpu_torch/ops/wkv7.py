"""WKV7 — the RWKV-7 "Goose" recurrent state update, plain PyTorch.

Math (per head h, for each token t; state S is an (N, N) matrix with row index i =
value dim, column index j = key dim):

    decay_j = exp(-e^{-1/2} * sigmoid(w_raw_j)) - 1 + dither(elapsed + t)
    sa_i    = sum_j a_j * S_ij                        # S @ a
    S_ij   += S_ij * decay_j + k_j * v_i + sa_i * b_j # S <- S diag(w) + v k^T + (S a) b^T
    y_i     = sum_j S_ij * r_j                        # y = S r

where the caller passes a = -kk and b = kk * (in-context learning rate), kk being the
per-head L2-normalized key. The "dither" (rotator1) decorrelates the rounding of a
16-bit state across steps: 2^-41 * float(int32(2654435769 * (elapsed + t))).

State layout: each request's per-layer state is one (N, H*N) matrix with element
[i, h*N + j] = S^{(h)}_ij — the layout of the JAX package, so snapshots mean the same
thing in both.
"""

from __future__ import annotations

from typing import Optional

import torch

HEAD_SIZE = 64

_EXP_NEG_HALF = 0.6065306597126334  # e^{-1/2}
_DITHER_SCALE = 2.0 ** -41
_DITHER_MULT = 2654435769


def dither(step_index: torch.Tensor) -> torch.Tensor:
    """rotator1: pseudo-random in ~(-2^-10, 2^-10) from an integer token counter.

    The uint32 product wraps (int64 multiply, low 32 bits) and is then read as an
    int32, so counters past 2^31 give the same bits as a 32-bit machine multiply."""
    u = (step_index.to(torch.int64) * _DITHER_MULT) & 0xFFFFFFFF
    s = torch.where(u >= 2 ** 31, u - 2 ** 32, u)
    return s.to(torch.float32) * _DITHER_SCALE


def decay_from_raw(w_raw: torch.Tensor, step_index: torch.Tensor,
                   use_dither: bool = True) -> torch.Tensor:
    """Raw decay logits -> the multiplier offset `decay - 1 (+ dither)`, float32."""
    d = torch.exp(-_EXP_NEG_HALF * torch.sigmoid(w_raw.to(torch.float32))) - 1.0
    if use_dither:
        d = d + dither(step_index)
    return d


def wkv7_reference_batch(state, r, w_raw, k, v, a, b, elapsed, *,
                         use_dither: bool = True,
                         lengths: Optional[torch.Tensor] = None):
    """WKV7 over T tokens for B requests, float32, a Python loop over T.

    state: (B, N, H*N); r, w_raw, k, v, a, b: (B, T, C); elapsed: (B,) int token
    counters (not advanced here: every layer of a forward sees the same counter).
    lengths: optional (B,) — tokens at or past a row's length leave its state
    untouched and produce zeros (ragged batches).

    Returns y (B, T, C) float32 and the new state in state's dtype."""
    B, T, C = r.shape
    N = HEAD_SIZE
    H = C // N
    f32 = torch.float32

    def heads(x):
        return x.to(f32).reshape(B, T, H, N)

    rs, ws, ks, vs, as_, bs = (heads(x) for x in (r, w_raw, k, v, a, b))
    S = state.to(f32).reshape(B, N, H, N).permute(0, 2, 1, 3)  # (B, H, i, j)
    ys = []
    for t in range(T):
        d = decay_from_raw(ws[:, t], (elapsed + t).reshape(B, 1, 1),
                           use_dither=use_dither)
        sa = torch.einsum("bhij,bhj->bhi", S, as_[:, t])
        S_new = (S + S * d[:, :, None, :] + vs[:, t, :, :, None] * ks[:, t, :, None, :]
                 + sa[..., None] * bs[:, t, :, None, :])
        y = torch.einsum("bhij,bhj->bhi", S_new, rs[:, t])
        if lengths is not None:
            act = (t < lengths).reshape(B, 1, 1)
            S_new = torch.where(act[..., None], S_new, S)
            y = torch.where(act, y, torch.zeros_like(y))
        S = S_new
        ys.append(y.reshape(B, C))
    new_state = S.permute(0, 2, 1, 3).reshape(B, N, C).to(state.dtype)
    return torch.stack(ys, dim=1), new_state
