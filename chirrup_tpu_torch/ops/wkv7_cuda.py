"""The fused WKV7 decode step: CUDA kernel (csrc/wkv7_step.cu) and its plain
PyTorch version.

One decode token of the recurrence on layer `layer` of the stacked state, with
the TMix prologue (per-head L2 norm of k*k_k; k~ = k*(1+(a-1)*k_a)) and epilogue
(per-head GroupNorm, eps 64e-5, *ln_w+ln_b; plus (sum_head r*k~*r_k)*v) fused in.
Rows with length 0 keep their state and output zeros.
"""

from __future__ import annotations

import torch

from chirrup_tpu_torch.ops import _kernels
from chirrup_tpu_torch.ops.wkv7 import HEAD_SIZE, decay_from_raw

_SOURCE = "wkv7_step"
_P, _I = _kernels.P, _kernels.I
_SIGNATURES = {"wkv7_step_fused": [_P] * 14 + [_I] * 11 + [_P]}


def wkv7_step_fused_reference(state_l, r, w_raw, k_raw, a_iclr, v, k_k, k_a, r_k,
                              ln_w, ln_b, elapsed, lengths, *, use_dither=True):
    """Plain version of the kernel on one layer's slab, without side effects.

    state_l: (B, N, C) layer slab; r, w_raw, k_raw, a_iclr, v: (B, C); k_k, k_a,
    r_k, ln_w, ln_b: (C,); elapsed, lengths: (B,) int32. Returns y (B, C) in
    r.dtype and the new slab in state_l.dtype (inactive rows bit-unchanged)."""
    B, C = r.shape
    N = HEAD_SIZE
    H = C // N
    f32 = torch.float32

    def heads(x):
        return x.to(f32).reshape(B, H, N)

    def param(x):
        return x.to(f32).reshape(H, N)

    kr, ai, rr, vv = heads(k_raw), heads(a_iclr), heads(r), heads(v)
    kk_pre = kr * param(k_k)
    kk = kk_pre / torch.sqrt((kk_pre * kk_pre).sum(-1, keepdim=True)).clamp_min(1e-12)
    kt = kr * (1.0 + (ai - 1.0) * param(k_a))
    d1 = 1.0 + decay_from_raw(heads(w_raw), elapsed.reshape(B, 1, 1),
                              use_dither=use_dither)
    active = (lengths > 0).reshape(B, 1, 1)
    d1 = torch.where(active, d1, 1.0)
    k_row = torch.where(active, kt, 0.0)
    b_row = torch.where(active, kk * ai, 0.0)

    S = state_l.to(f32).reshape(B, N, H, N).permute(0, 2, 1, 3)  # (B, H, i, j)
    sa = torch.einsum("bhij,bhj->bhi", S, -kk)
    S_new = (S * d1[:, :, None, :] + vv[..., :, None] * k_row[..., None, :]
             + sa[..., None] * b_row[..., None, :])
    y = torch.einsum("bhij,bhj->bhi", S_new, rr)
    mu = y.mean(-1, keepdim=True)
    var = ((y - mu) ** 2).mean(-1, keepdim=True)
    y = (y - mu) * torch.rsqrt(var + 64e-5) * param(ln_w) + param(ln_b)
    y = y + (rr * kt * param(r_k)).sum(-1, keepdim=True) * vv
    y = torch.where(active, y, 0.0).reshape(B, C).to(r.dtype)
    new = S_new.permute(0, 2, 1, 3).reshape(B, N, C).to(state_l.dtype)
    new = torch.where(active, new, state_l)
    return y, new


def wkv7_step_fused(state, layer: int, r, w_raw, k_raw, a_iclr, v, k_k, k_a, r_k,
                    ln_w, ln_b, elapsed, lengths, *, use_dither: bool = True):
    """Advance layer `layer` of the stacked state (L, B, N, C) by one token, in
    place; returns y (B, C) in r.dtype. r/w_raw/k_raw/a_iclr/v: (B, C) rows with
    unit column stride (row strides may differ); k_k, k_a, r_k, ln_w, ln_b: (C,)
    in r.dtype; elapsed, lengths: (B,) int32."""
    if state.device.type == "cpu":
        y, new = wkv7_step_fused_reference(
            state[layer], r, w_raw, k_raw, a_iclr, v, k_k, k_a, r_k, ln_w, ln_b,
            elapsed, lengths, use_dither=use_dither)
        state[layer].copy_(new)
        return y
    if not state.is_cuda:
        raise ValueError(f"wkv7_step_fused: no kernel for device {state.device}")
    L, B, N, C = state.shape
    dev = state.device
    if N != HEAD_SIZE or C % HEAD_SIZE:
        raise ValueError(f"wkv7_step_fused: state {tuple(state.shape)} is not "
                         f"(L, B, {HEAD_SIZE}, H*{HEAD_SIZE})")
    if not 0 <= layer < L:
        raise IndexError(f"wkv7_step_fused: layer {layer} out of range [0, {L})")
    _kernels.require(state, "state", device=dev, align=16)  # 16-byte row loads
    act = r.dtype
    rows = (r, w_raw, k_raw, a_iclr, v)
    for name, t in zip(("r", "w_raw", "k_raw", "a_iclr", "v"), rows):
        if t.dtype != act or t.device != dev or tuple(t.shape) != (B, C) \
                or t.stride(1) != 1:
            raise ValueError(f"wkv7_step_fused: {name} must be ({B}, {C}) {act} on "
                             f"{dev} with unit column stride, got "
                             f"{tuple(t.shape)} {t.dtype} {t.device} {t.stride()}")
    for name, t in zip(("k_k", "k_a", "r_k", "ln_w", "ln_b"),
                       (k_k, k_a, r_k, ln_w, ln_b)):
        _kernels.require(t, name, dtype=act, shape=(C,), device=dev)
    for name, t in (("elapsed", elapsed), ("lengths", lengths)):
        _kernels.require(t, name, dtype=torch.int32, shape=(B,), device=dev)
    y = torch.empty((B, C), dtype=act, device=dev)
    lib = _kernels.library(_SOURCE, _SIGNATURES)
    code = lib.wkv7_step_fused(
        state.data_ptr(), *(t.data_ptr() for t in rows), k_k.data_ptr(),
        k_a.data_ptr(), r_k.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(),
        elapsed.data_ptr(), lengths.data_ptr(), y.data_ptr(), B, C, layer,
        int(use_dither), *(t.stride(0) for t in rows), _kernels.dtype_code(r, "r"),
        _kernels.dtype_code(state, "state"), _kernels.stream_of(state))
    _kernels.LAUNCHES["wkv7_step_fused"] += 1
    _kernels.check(lib, _SOURCE, "wkv7_step_fused", code)
    return y
