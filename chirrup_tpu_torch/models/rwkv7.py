"""RWKV-7 "Goose" forward in PyTorch over a parameter tree and an explicit
recurrent state.

Recurrent state of a batch of B requests:
  shift:   (L, 2, B, C)   token-shift x_prev for TMix [0] and CMix [1]
  wkv:     (L, B, N, H*N) per-head matrix state, layout [i, h*N+j] (see ops/wkv7.py)
  elapsed: (B,) int32     total tokens processed (feeds the dither)

The state is updated IN PLACE, layer by layer: a decode step writes each
layer's slab where it lies instead of building a new stacked state.

Parameters are a nested dict of tensors stacked over a leading layer axis, with
linears stored (in, out) for `x @ W`; INT8 linears are Mm8Weight (or the merged
Mm8MultiWeight) and are handed to the kernels as LayerIndexed views.

Every forward takes `mm8_core`, the int8 GEMM of the INT8 linears ("auto" or
"pallas_a8" w8a8, or "pallas" w8a16; ops/mm8.resolve_mm8_core; merged R/K/V
weights run under w8a8 only), `wkv_fn` and `wkv_precision`. wkv_fn None runs
the fused WKV kernels (the kk/k~ prologue, GroupNorm and the bonus inside the
kernel) in the arithmetic `wkv_precision` names ("highest", "default" or
"bf16"; ops/wkv7_cuda.bf16_mode); a callable runs the unfused TMix tail around
it. The callable has the signature of ops/wkv7_cuda.wkv7_batch,

    wkv_fn(state, r, w_raw, k, v, a, b, elapsed, lengths, layer, *, use_dither)

and advances layer `layer` of the stacked state IN PLACE, returning y (B, T,
C); the JAX package's wkv_fn returns (y, new_state) instead. It carries its
own precision, as the JAX package's raw_wkv closes over the runtime's:
functools.partial(wkv7_batch, precision="bf16").
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from chirrup_tpu_torch import resolve_device
from chirrup_tpu_torch.models.config import HEAD_SIZE, RWKV7Config
from chirrup_tpu_torch.ops import mm8
from chirrup_tpu_torch.ops.linear import matmul
from chirrup_tpu_torch.ops.wkv7_cuda import wkv7_chunk_fused, wkv7_step_fused

_MM8_TYPES = (mm8.Mm8Weight, mm8.Mm8MultiWeight)


@dataclasses.dataclass
class RWKVState:
    """Recurrent state for a batch of B requests (mutated in place)."""

    shift: torch.Tensor    # (L, 2, B, C)
    wkv: torch.Tensor      # (L, B, N, H*N)
    elapsed: torch.Tensor  # (B,) int32


def init_state(config: RWKV7Config, batch_size: int, *, shift_dtype=torch.float32,
               wkv_dtype=torch.float32, device=None) -> RWKVState:
    """A zero state of `batch_size` requests on `device` (resolve_device: the
    CUDA device unless one is given)."""
    L, C, N = config.n_layer, config.n_embd, config.head_size
    device = resolve_device(device)
    return RWKVState(
        shift=torch.zeros((L, 2, batch_size, C), dtype=shift_dtype, device=device),
        wkv=torch.zeros((L, batch_size, N, C), dtype=wkv_dtype, device=device),
        elapsed=torch.zeros((batch_size,), dtype=torch.int32, device=device))


# --------------------------------------------------------------------- norms

def layer_norm(x, w, b, eps=1e-5):
    out = F.layer_norm(x.to(torch.float32), (x.shape[-1],), w.to(torch.float32),
                       b.to(torch.float32), eps)
    return out.to(x.dtype)


def group_norm(x, num_groups, w, b, eps):
    """Per-head GroupNorm over (..., C) with C = num_groups * head_size, float32
    inside, out in x.dtype (the TMix tail uses eps 64e-5)."""
    shape = x.shape
    xf = x.to(torch.float32).reshape(*shape[:-1], num_groups, shape[-1] // num_groups)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    xn = ((xf - mu) * torch.rsqrt(var + eps)).reshape(shape)
    return (xn * w.to(torch.float32) + b.to(torch.float32)).to(x.dtype)


def l2_normalize_heads(x, H, N):
    """Per-head x / max(||x||, 1e-12), float32 inside, out in x.dtype."""
    shape = x.shape
    xf = x.to(torch.float32).reshape(*shape[:-1], H, N)
    out = xf / torch.sqrt((xf * xf).sum(-1, keepdim=True)).clamp_min(1e-12)
    return out.reshape(shape).to(x.dtype)


def _masked_last(x, lengths, prev):
    """Last valid position of each row of x (B, T, C); rows with length 0 keep prev."""
    B, T, _ = x.shape
    if lengths is None:
        return x[:, -1, :].to(prev.dtype)
    if T == 1:
        last = x[:, 0]
    else:
        idx = (lengths.long() - 1).clamp(0, T - 1)
        last = torch.gather(x, 1, idx.reshape(B, 1, 1).expand(B, 1, x.shape[-1]))[:, 0]
    return torch.where((lengths > 0)[:, None], last.to(prev.dtype), prev)


def _token_shift_delta(x, shift_prev):
    """xx = [shift_prev, x[:-1]] - x along T."""
    prev = shift_prev[:, None, :].to(x.dtype)
    if x.shape[1] == 1:
        return prev - x
    return torch.cat([prev, x[:, :-1]], dim=1) - x


def layer_params(blocks, li: int):
    """Layer li of the stacked block tree: dense leaves indexed (views),
    INT8 weights wrapped as LayerIndexed (codes never sliced)."""
    if isinstance(blocks, dict):
        return {k: layer_params(v, li) for k, v in blocks.items()}
    if isinstance(blocks, _MM8_TYPES):
        return mm8.LayerIndexed(blocks, li)
    return blocks[li]


# -------------------------------------------------------------------- blocks

def _tmix(att, li, layer_is_first, x, shift_prev, v_first, wkv_full, elapsed, lengths,
          use_dither, mm8_core, wkv_fn, wkv_precision):
    """Time-mix. Advances layer li of the stacked wkv state in place and returns
    (out, new_shift, v_first)."""
    B, T, C = x.shape
    xx = _token_shift_delta(x, shift_prev)

    def mm(x, w, **kw):
        return matmul(x, w, mm8_core=mm8_core, **kw)

    if "Wrkv" in att:
        # merged R/K/V (the w8a8 core only): one quantize + one GEMM off the
        # shared (x, xx) pair
        if mm8.resolve_mm8_core(mm8_core) != "pallas_a8":
            raise ValueError(f"merged R/K/V weights (Wrkv) run only under the w8a8 core, "
                             f"not mm8_core {mm8_core!r}")
        rkv = mm8.mm8_multi_matmul(x, xx, att["mu_rkv"], att["Wrkv"])
        r, k, v = rkv.split(C, dim=-1)
    else:
        r = mm(x + xx * att["x_r"], att["Wr"])
        k = mm(x + xx * att["x_k"], att["Wk"])
        v = mm(x + xx * att["x_v"], att["Wv"])

    if "lora1" in att:
        # packed LoRA chains (w / a / v-gate / g): two batched matmuls
        X4 = x.reshape(1, B * T, C) + xx.reshape(1, B * T, C) * att["mu_lora"][:, None, :]
        s1 = torch.bmm(X4, att["lora1"])
        s1 = torch.stack([torch.tanh(s1[0]), s1[1], s1[2], torch.sigmoid(s1[3])])
        s2 = torch.bmm(s1, att["lora2"]).reshape(4, B, T, C)
        w_raw = s2[0] + att["w0"]
        a = torch.sigmoid(s2[1] + att["a0"])
        v_gate_pre = s2[2] + att["v0"]
        g = s2[3]
    else:
        w_raw = mm(torch.tanh(mm(x + xx * att["x_w"], att["w1"])), att["w2"]) + att["w0"]
        a = torch.sigmoid(mm(mm(x + xx * att["x_a"], att["a1"]), att["a2"]) + att["a0"])
        g = mm(torch.sigmoid(mm(x + xx * att["x_g"], att["g1"])), att["g2"])
        v_gate_pre = mm(mm(x + xx * att["x_v"], att["v1"]), att["v2"]) + att["v0"]

    # layer 0 captures v_first; later layers blend toward it
    if layer_is_first:
        v_first = v
    else:
        v = v + (v_first - v) * torch.sigmoid(v_gate_pre)

    if wkv_fn is not None:
        # unfused: kk / k~ here, the bare recurrence, then GroupNorm (ln_b at
        # masked positions, as in the JAX package) and the bonus
        H = C // HEAD_SIZE
        kk = l2_normalize_heads(k * att["k_k"], H, HEAD_SIZE)
        k = k * (1 + (a - 1) * att["k_a"])
        y = wkv_fn(wkv_full, r, w_raw, k, v, -kk, kk * a, elapsed, lengths, li,
                   use_dither=use_dither).to(x.dtype)
        y = group_norm(y, H, att["ln_x_w"], att["ln_x_b"], eps=64e-5)
        bonus = (r * k * att["r_k"].reshape(-1)).reshape(B, T, H, HEAD_SIZE) \
            .sum(-1, keepdim=True)
        y = y + (bonus * v.reshape(B, T, H, HEAD_SIZE)).reshape(B, T, C)
        out = mm(y, att["Wo"], mul_in=g)
        return out, _masked_last(x, lengths, shift_prev), v_first

    # kk / k~ prologue and GroupNorm + bonus epilogue ride the WKV kernel: one
    # token (decode) or a chunk of T (prefill); y is zero past each row's length
    ln = lengths
    if ln is None:
        ln = torch.full((B,), T, dtype=torch.int32, device=x.device)
    wkv_args = (att["k_k"], att["k_a"], att["r_k"].reshape(-1), att["ln_x_w"],
                att["ln_x_b"], elapsed, ln)
    if T == 1:
        y = wkv7_step_fused(wkv_full, li, r[:, 0], w_raw[:, 0], k[:, 0], a[:, 0], v[:, 0],
                            *wkv_args, use_dither=use_dither,
                            precision=wkv_precision).reshape(B, 1, C)
    else:
        y = wkv7_chunk_fused(wkv_full, li, r, w_raw, k, a, v, *wkv_args,
                             use_dither=use_dither, precision=wkv_precision)
    out = mm(y.to(x.dtype), att["Wo"], mul_in=g)
    return out, _masked_last(x, lengths, shift_prev), v_first


def _cmix(ffn, x, shift_prev, lengths, mm8_core):
    """Channel-mix FFN with relu^2."""
    xx = _token_shift_delta(x, shift_prev)
    kx = x + xx * ffn["x_k"]
    if isinstance(ffn["Wk"], mm8.LayerIndexed) and isinstance(ffn["Wv"], mm8.LayerIndexed):
        out = mm8.mm8_ffn_matmul(kx, ffn["Wk"], ffn["Wv"], core=mm8_core)
    else:
        out = matmul(matmul(kx, ffn["Wk"], activation="relu2", mm8_core=mm8_core),
                     ffn["Wv"], mm8_core=mm8_core)
    return out, _masked_last(x, lengths, shift_prev)


def _backbone(params, x, state: RWKVState, lengths, use_dither, mm8_core, wkv_fn,
              wkv_precision):
    """All layers; the state's shift and wkv are written in place per layer."""
    blocks = params["blocks"]
    L = state.wkv.shape[0]
    v_first = None
    for li in range(L):
        blk = layer_params(blocks, li)
        shift_l = state.shift[li]
        xn = layer_norm(x, blk["ln1_w"], blk["ln1_b"])
        att_out, att_shift, v_first = _tmix(
            blk["att"], li, li == 0, xn, shift_l[0], v_first, state.wkv,
            state.elapsed, lengths, use_dither, mm8_core, wkv_fn, wkv_precision)
        x = x + att_out
        xn = layer_norm(x, blk["ln2_w"], blk["ln2_b"])
        ffn_out, ffn_shift = _cmix(blk["ffn"], xn, shift_l[1], lengths, mm8_core)
        x = x + ffn_out
        shift_l[0].copy_(att_shift)
        shift_l[1].copy_(ffn_shift)
    return x


def _embed(params, tokens, dtype):
    emb = params["emb"]
    return F.embedding(tokens.long().clamp(0, emb.shape[0] - 1), emb).to(dtype)


def forward_step(params, tokens, state: RWKVState, active=None, *,
                 compute_dtype=torch.float32, use_dither=True, mm8_core="auto",
                 wkv_fn: Optional[Callable] = None, wkv_precision="default"):
    """One-token step for the whole batch: tokens (B,) -> logits (B, V) in the
    head's output dtype; the state advances in place. active: optional (B,)
    bool — inactive rows keep their state and yield unused logits. mm8_core,
    wkv_fn and wkv_precision: see the module docstring."""
    lengths = None if active is None else active.to(torch.int32)
    x = _embed(params, tokens[:, None], compute_dtype)
    x = _backbone(params, x, state, lengths, use_dither, mm8_core, wkv_fn, wkv_precision)
    xh = layer_norm(x[:, 0], params["ln_out_w"], params["ln_out_b"])
    logits = matmul(xh, params["head"], mm8_core=mm8_core)
    state.elapsed += (torch.ones_like(state.elapsed) if lengths is None else lengths)
    return logits, state


def forward_chunk(params, tokens, state: RWKVState, lengths=None, *,
                  compute_dtype=torch.float32, use_dither=True, mm8_core="auto",
                  wkv_fn: Optional[Callable] = None, wkv_precision="default") -> RWKVState:
    """Prefill a chunk: advance the state in place over tokens (B, T); no head
    (the last prompt token always goes through forward_step). lengths: optional
    (B,) int32 valid tokens per row; rows may be ragged or empty (length 0
    keeps the row's state), and each row's shift comes from its last valid
    token. mm8_core, wkv_fn and wkv_precision: see the module docstring."""
    x = _embed(params, tokens, compute_dtype)
    _backbone(params, x, state, lengths, use_dither, mm8_core, wkv_fn, wkv_precision)
    state.elapsed += tokens.shape[1] if lengths is None else lengths
    return state


def forward_seq(params, tokens, state: RWKVState, *, full_output=False,
                compute_dtype=torch.float32, use_dither=True, mm8_core="auto",
                wkv_fn: Optional[Callable] = None, wkv_precision="default"):
    """Whole-sequence forward with logits: tokens (B, T). Returns float32 logits
    (B, V), or (B, T, V) with full_output; the state advances in place. The
    eval / oracle entry. mm8_core, wkv_fn and wkv_precision: see the module
    docstring."""
    x = _embed(params, tokens, compute_dtype)
    x = _backbone(params, x, state, None, use_dither, mm8_core, wkv_fn, wkv_precision)
    if not full_output:
        x = x[:, -1:, :]
    logits = matmul(layer_norm(x, params["ln_out_w"], params["ln_out_b"]),
                    params["head"], mm8_core=mm8_core).to(torch.float32)
    state.elapsed += tokens.shape[1]
    return (logits if full_output else logits[:, 0]), state


def cast_dense(params, dtype: Optional[torch.dtype] = None,
               device: Optional[torch.device] = None):
    """Dense float leaves to `dtype` (when given) and every leaf to `device`
    (when given); INT8 weights keep their int8 codes and float32 scales."""
    if isinstance(params, dict):
        return {k: cast_dense(v, dtype, device) for k, v in params.items()}
    if isinstance(params, _MM8_TYPES):
        return params if device is None else type(params)(
            *(getattr(params, f.name).to(device) for f in dataclasses.fields(params)))
    out = params.to(device) if device is not None else params
    return out.to(dtype) if dtype is not None and out.is_floating_point() else out
