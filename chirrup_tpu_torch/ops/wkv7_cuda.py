"""The WKV7 kernels, with their plain PyTorch versions: the fused decode step
(csrc/wkv7_step.cu), the fused prefill chunk (csrc/wkv7_chunk.cu) and the bare
recurrence over any T (csrc/wkv7_batch.cu).

Each advances layer `layer` of the stacked state by tokens of the recurrence.
The fused kernels carry the TMix prologue (per-head L2 norm of k*k_k;
k~ = k*(1+(a-1)*k_a)) and epilogue (per-head GroupNorm, eps 64e-5,
*ln_w+ln_b; plus (sum_head r*k~*r_k)*v); the bare one takes a, b and k~
precomputed and returns raw y. Positions at or past a row's length output
zeros and leave its state alone; a row with length 0 keeps its state bit for
bit.

Each takes the JAX package's WKV `precision` (bf16_mode): "highest" and
"default" run the float32 state math; "bf16" on a bf16 state runs the delta
form in bf16 (_bf16_token), in instances of each kernel of their own,
counted apart in _kernels.LAUNCHES ("<kernel>_bf16").

The step kernel's launch (state rows a thread, threads a row) is fixed in
csrc/wkv7_step.cu and described by ``step_plan``. The chunk kernel's launch
(state rows a thread, threads a row, tokens a tile) is fixed in
csrc/wkv7_chunk.cu and described by ``chunk_plan``; its inputs arrive by
16-byte asynchronous copies, so each row of r, w, k, a and v must start on a
16-byte boundary (``check_chunk_operands``). The bare kernel has three
launches, fixed in csrc/wkv7_batch.cu and chosen by ``batch_plan`` from T
and the arithmetic: the step kernel's row layout at T = 1, the chunked WY
form on the tensor cores (``wkv7_batch_chunked_reference`` is its algebra)
for T > 1 in float32 state math, and the chunk kernel's per-token layout for
T > 1 in the bf16 arithmetic.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from chirrup_tpu_torch.ops import _kernels
from chirrup_tpu_torch.ops.wkv7 import HEAD_SIZE, decay_from_raw, wkv7_reference_batch

_P, _I = _kernels.P, _kernels.I
_SIGNATURES = {
    "wkv7_step": {"wkv7_step_fused": [_P] * 14 + [_I] * 16 + [_P]},
    "wkv7_chunk": {"wkv7_chunk_fused": [_P] * 14 + [_I] * 18 + [_P]},
    "wkv7_batch": {"wkv7_batch": [_P] * 10 + [_I] * 26 + [_P]},
}


def _bf16_token(S, d1, r, k, a, b, v):
    """One token of the precision="bf16" arithmetic on a bf16 state S (B, H,
    i, j): d1 = 1 + decay, r, k, a, b (B, H, j) and v (B, H, i) float32
    rows, folded for activity by the caller. Every elementwise operation is
    a bf16 operation rounded to nearest (CPU and CUDA torch round each one);
    the two sums over j are float32, over bf16 products:

        sa_i = sum_j S_ij * bf16(a_j)
        S'   = S + ((S * bf16(d1 - 1) + bf16(v) bf16(k)^T) + bf16(sa) bf16(b)^T)
        y_i  = sum_j S_ij * bf16(d1_j r_j) + v_i <r, k> + sa_i <r, b>

    the delta form, whose rounding is relative to the step's change (S *
    bf16(d1) would freeze slow decays at bf16's step below 1, 2^-8), and y
    from the old S in the 2-dot form. Returns y (B, H, i) float32 and S'."""
    bf, f32 = torch.bfloat16, torch.float32
    a_, b_, k_, v_ = (x.to(bf) for x in (a, b, k, v))
    sa = (S * a_[..., None, :]).to(f32).sum(-1)
    y1 = (S * (d1 * r).to(bf)[..., None, :]).to(f32).sum(-1)
    d_ = (d1 - 1.0).to(bf)
    delta = ((S * d_[..., None, :] + v_[..., :, None] * k_[..., None, :])
             + sa.to(bf)[..., None] * b_[..., None, :])
    y = y1 + v * (r * k).sum(-1, keepdim=True) + sa * (r * b).sum(-1, keepdim=True)
    return y, S + delta


def _fused_token(S, r, w_raw, k_raw, a_iclr, v, k_k, k_a, r_k, ln_w, ln_b, step,
                 active, use_dither):
    """One token on the state S (B, H, i, j): r..v (B, C) rows, k_k..ln_b (C,),
    step (B,) int64 dither counters, active (B,) bool. A float32 S takes the
    float32 update; a bf16 S the precision="bf16" arithmetic (_bf16_token).
    Returns y (B, C) float32, zero where inactive, and the new S in S's dtype
    (inactive rows exactly S)."""
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
    inv = 1.0 / torch.sqrt((kk_pre * kk_pre).sum(-1, keepdim=True)).clamp_min(1e-12)
    kk = kk_pre * inv  # a multiply by the reciprocal, as the kernels and the JAX package
    kt = kr * (1.0 + (ai - 1.0) * param(k_a))
    d1 = 1.0 + decay_from_raw(heads(w_raw), step.reshape(B, 1, 1), use_dither=use_dither)
    act = active.reshape(B, 1, 1)
    d1 = torch.where(act, d1, 1.0)
    k_row = torch.where(act, kt, 0.0)
    b_row = torch.where(act, kk * ai, 0.0)

    if S.dtype == torch.bfloat16:
        y, S_new = _bf16_token(S, d1, rr, k_row, -kk, b_row, vv)
        S_new = torch.where(act[..., None], S_new, S)
    else:
        sa = torch.einsum("bhij,bhj->bhi", S, -kk)
        S_new = (S * d1[:, :, None, :] + vv[..., :, None] * k_row[..., None, :]
                 + sa[..., None] * b_row[..., None, :])
        y = torch.einsum("bhij,bhj->bhi", S_new, rr)
    mu = y.mean(-1, keepdim=True)
    var = ((y - mu) ** 2).mean(-1, keepdim=True)
    y = (y - mu) * torch.rsqrt(var + 64e-5) * param(ln_w) + param(ln_b)
    y = y + (rr * kt * param(r_k)).sum(-1, keepdim=True) * vv
    return torch.where(act, y, 0.0).reshape(B, C), S_new


def _heads_of(state_l, bf16=False):
    """(B, N, H*N) slab -> (B, H, i, j): the slab's bf16 as it is where
    `bf16` (the precision="bf16" arithmetic), else float32."""
    B, N, C = state_l.shape
    dtype = torch.bfloat16 if bf16 else torch.float32
    return state_l.to(dtype).reshape(B, N, C // N, N).permute(0, 2, 1, 3)


def _slab_of(S, like):
    """(B, H, i, j) -> a (B, N, H*N) slab in like's dtype."""
    B, H, N, _ = S.shape
    return S.permute(0, 2, 1, 3).reshape(B, N, H * N).to(like.dtype)


PRECISIONS = ("highest", "default", "bf16")


def bf16_mode(fn, precision, state_dtype) -> bool:
    """The JAX package's WKV precisions (wkv7_pallas._parse_precision):
    "highest" and "default" keep the state math in float32 (the port runs
    both alike); "bf16" runs the delta form in bf16 (_bf16_token) when the
    state is bf16, and the float32 math on a float32 state. True where the
    bf16 arithmetic applies; raises ValueError for any other precision."""
    if precision not in PRECISIONS:
        raise ValueError(f"{fn}: unknown precision {precision!r}")
    return precision == "bf16" and state_dtype == torch.bfloat16


def wkv7_step_fused_reference(state_l, r, w_raw, k_raw, a_iclr, v, k_k, k_a, r_k,
                              ln_w, ln_b, elapsed, lengths, *, use_dither=True,
                              precision="default"):
    """Plain version of the decode kernel on one layer's slab, without side
    effects.

    state_l: (B, N, C) layer slab; r, w_raw, k_raw, a_iclr, v: (B, C); k_k, k_a,
    r_k, ln_w, ln_b: (C,); elapsed, lengths: (B,) int32; precision: see
    bf16_mode. Returns y (B, C) in r.dtype and the new slab in state_l.dtype
    (inactive rows bit-unchanged)."""
    bf16 = bf16_mode("wkv7_step_fused_reference", precision, state_l.dtype)
    active = lengths > 0
    y, S = _fused_token(_heads_of(state_l, bf16), r, w_raw, k_raw, a_iclr, v, k_k, k_a,
                        r_k, ln_w, ln_b, elapsed.to(torch.int64), active, use_dither)
    new = torch.where(active[:, None, None], _slab_of(S, state_l), state_l)
    return y.to(r.dtype), new


def wkv7_chunk_fused_reference(state_l, r, w_raw, k_raw, a_iclr, v, k_k, k_a, r_k,
                               ln_w, ln_b, elapsed, lengths, *, use_dither=True,
                               precision="default"):
    """Plain version of the chunk kernel on one layer's slab, without side
    effects: tokens t < lengths[b] of each row in order. The state is carried
    in float32 across the chunk and rounded to its dtype once at the end;
    under the bf16 arithmetic (bf16_mode) it stays bf16, rounded every token.

    state_l: (B, N, C); r, w_raw, k_raw, a_iclr, v: (B, T, C); k_k, k_a, r_k,
    ln_w, ln_b: (C,); elapsed, lengths: (B,) int32 (token t's dither counter is
    elapsed + t). Returns y (B, T, C) in r.dtype, zero at t >= lengths, and the
    new slab in state_l.dtype (rows of length 0 bit-unchanged)."""
    bf16 = bf16_mode("wkv7_chunk_fused_reference", precision, state_l.dtype)
    T = r.shape[1]
    S = _heads_of(state_l, bf16)
    ys = []
    for t in range(T):
        y, S = _fused_token(S, r[:, t], w_raw[:, t], k_raw[:, t], a_iclr[:, t], v[:, t],
                            k_k, k_a, r_k, ln_w, ln_b, elapsed.to(torch.int64) + t,
                            t < lengths, use_dither)
        ys.append(y)
    new = torch.where((lengths > 0)[:, None, None], _slab_of(S, state_l), state_l)
    return torch.stack(ys, dim=1).to(r.dtype), new


def _check_common(fn, state, layer, act, dev, params, B, elapsed, lengths):
    L, _, N, C = state.shape
    if N != HEAD_SIZE or C % HEAD_SIZE:
        raise ValueError(f"{fn}: state {tuple(state.shape)} is not "
                         f"(L, B, {HEAD_SIZE}, H*{HEAD_SIZE})")
    if not 0 <= layer < L:
        raise IndexError(f"{fn}: layer {layer} out of range [0, {L})")
    _kernels.require(state, "state", device=dev, align=16)  # 16-byte row loads
    for name, t in zip(("k_k", "k_a", "r_k", "ln_w", "ln_b"), params):
        _kernels.require(t, name, dtype=act, shape=(C,), device=dev)
    for name, t in (("elapsed", elapsed), ("lengths", lengths)):
        _kernels.require(t, name, dtype=torch.int32, shape=(B,), device=dev)


class StepPlan(NamedTuple):
    """The step kernel's launch: one block of `threads` = heads_per_block *
    64 / rows_per_thread * threads_per_row per `heads_per_block` neighbouring
    heads of one request. Thread t of a block is in lane group t //
    threads_per_row, which holds head slot (t // threads_per_row) %
    heads_per_block and rows rows_per_thread * (t // threads_per_row //
    heads_per_block) onwards; each thread 64 / threads_per_row consecutive
    columns of its rows, a row's threads (neighbouring lanes) joining its
    sums with shuffles. Slots past the last head store nothing. The wrapper
    hands the plan to the kernel's entry, which refuses any launch shape but
    its own."""
    heads_per_block: int
    rows_per_thread: int
    threads_per_row: int
    threads: int
    grid: Tuple[int, int, int]


def step_plan(B: int, C: int) -> StepPlan:
    """The launch of the step kernel for B requests at width C, as
    csrc/wkv7_step.cu fixes it: four heads a block, sixteen state rows a
    thread and eight threads a row (128 threads), so a warp load instruction
    reads one bf16 state row of four heads, 512 contiguous bytes. On the H100
    it was the fastest of the launch shapes timed with cold state at batch 64
    (PERF.md); it depends on neither B nor the card's SM count. Raises
    ValueError for shapes the kernel does not take (B is a grid dimension of
    at most 65,535)."""
    if not 1 <= B <= 65535 or C < HEAD_SIZE or C % HEAD_SIZE:
        raise ValueError(f"wkv7_step_fused: unsupported shapes B {B}, C {C}")
    heads = C // HEAD_SIZE
    return StepPlan(heads_per_block=4, rows_per_thread=16, threads_per_row=8, threads=128,
                    grid=(-(-heads // 4), B, 1))


def wkv7_step_fused(state, layer: int, r, w_raw, k_raw, a_iclr, v, k_k, k_a, r_k,
                    ln_w, ln_b, elapsed, lengths, *, use_dither: bool = True,
                    precision: str = "default"):
    """Advance layer `layer` of the stacked state (L, B, N, C) by one token, in
    place; returns y (B, C) in r.dtype. r/w_raw/k_raw/a_iclr/v: (B, C) rows with
    unit column stride (row strides may differ); k_k, k_a, r_k, ln_w, ln_b: (C,)
    in r.dtype; elapsed, lengths: (B,) int32; precision: see bf16_mode. The
    kernel (launched as step_plan says) on CUDA tensors, the plain version on
    CPU tensors."""
    bf16 = bf16_mode("wkv7_step_fused", precision, state.dtype)
    if state.device.type == "cpu":
        y, new = wkv7_step_fused_reference(
            state[layer], r, w_raw, k_raw, a_iclr, v, k_k, k_a, r_k, ln_w, ln_b,
            elapsed, lengths, use_dither=use_dither, precision=precision)
        state[layer].copy_(new)
        return y
    if not state.is_cuda:
        raise ValueError(f"wkv7_step_fused: no kernel for device {state.device}")
    B, C = state.shape[1], state.shape[3]
    dev, act = state.device, r.dtype
    _check_common("wkv7_step_fused", state, layer, act, dev, (k_k, k_a, r_k, ln_w, ln_b),
                  B, elapsed, lengths)
    plan = step_plan(B, C)  # raises for shapes the kernel does not take
    rows = (r, w_raw, k_raw, a_iclr, v)
    for name, t in zip(("r", "w_raw", "k_raw", "a_iclr", "v"), rows):
        if t.dtype != act or t.device != dev or tuple(t.shape) != (B, C) \
                or t.stride(1) != 1:
            raise ValueError(f"wkv7_step_fused: {name} must be ({B}, {C}) {act} on "
                             f"{dev} with unit column stride, got "
                             f"{tuple(t.shape)} {t.dtype} {t.device} {t.stride()}")
    y = torch.empty((B, C), dtype=act, device=dev)
    lib = _kernels.library("wkv7_step", _SIGNATURES["wkv7_step"])
    code = lib.wkv7_step_fused(
        state.data_ptr(), *(t.data_ptr() for t in rows), k_k.data_ptr(),
        k_a.data_ptr(), r_k.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(),
        elapsed.data_ptr(), lengths.data_ptr(), y.data_ptr(), B, C, layer,
        int(use_dither), *(t.stride(0) for t in rows), _kernels.dtype_code(r, "r"),
        _kernels.dtype_code(state, "state"), int(bf16), plan.heads_per_block,
        plan.rows_per_thread, plan.threads_per_row, plan.threads, _kernels.stream_of(state))
    _kernels.count_launch("wkv7_step_fused_bf16" if bf16 else "wkv7_step_fused")
    _kernels.check(lib, "wkv7_step", "wkv7_step_fused", code)
    return y


class ChunkPlan(NamedTuple):
    """The chunk kernel's launch: one block of `threads` = 64 /
    rows_per_thread * threads_per_row per (head, request); each thread holds
    64 / threads_per_row columns of `rows_per_thread` state rows, and a row's
    threads join its sums with shuffles; the chunk in tiles of `tile_tokens`
    tokens, double-buffered in shared memory."""
    rows_per_thread: int
    threads_per_row: int
    threads: int
    tile_tokens: int
    grid: Tuple[int, int, int]


def chunk_plan(P: int, T: int, C: int) -> ChunkPlan:
    """The launch of the chunk kernel for P requests of up to T tokens at
    width C, as csrc/wkv7_chunk.cu fixes it: four
    state rows a thread and eight threads a row (128 threads; each token's
    row vectors are read from shared memory once for four rows) and 16-token
    tiles (a chunk shorter than 16 fills part of one). On the H100 it was
    the fastest launch or within the run-to-run spread of it at every
    prefill variant (8, 64), (8, 256) and (32, 64) against other splits of
    the state and other tiles (PERF.md), so it depends on neither P nor the
    card's SM count. Raises ValueError for shapes the kernel does not take."""
    if P < 1 or T < 1 or C < HEAD_SIZE or C % HEAD_SIZE:
        raise ValueError(f"wkv7_chunk_fused: unsupported shapes P {P}, T {T}, C {C}")
    return ChunkPlan(rows_per_thread=4, threads_per_row=8, threads=128, tile_tokens=16,
                     grid=(C // HEAD_SIZE, P, 1))


def check_chunk_operands(state, layer, r, w_raw, k_raw, a_iclr, v, k_k, k_a, r_k, ln_w,
                         ln_b, elapsed, lengths):
    """What the chunk kernel takes, checked on the state's device: state (L,
    B, 64, H*64), 16-byte aligned; r..v (B, T, C) in one float dtype with unit
    column stride and every (request, token) row on a 16-byte boundary (its
    16-byte copies), strides below 2^31; k_k..ln_b (C,) in that dtype; elapsed,
    lengths (B,) int32. Returns the ten request and token strides. Raises
    TypeError, ValueError or IndexError on anything else."""
    B, T, C = r.shape
    dev, act = state.device, r.dtype
    _kernels.dtype_code(r, "r")
    if state.dim() != 4 or state.shape[1] != B or state.shape[3] != C:
        raise ValueError(f"wkv7_chunk_fused: state {tuple(state.shape)} does not hold "
                         f"{B} rows of width {C}")
    _check_common("wkv7_chunk_fused", state, layer, act, dev, (k_k, k_a, r_k, ln_w, ln_b),
                  B, elapsed, lengths)
    strides = []
    align = 16 // r.element_size()
    for name, t in zip(("r", "w_raw", "k_raw", "a_iclr", "v"), (r, w_raw, k_raw, a_iclr, v)):
        if t.dtype != act or t.device != dev or tuple(t.shape) != (B, T, C) \
                or t.stride(2) != 1 or max(t.stride(0), t.stride(1)) >= 2 ** 31:
            raise ValueError(f"wkv7_chunk_fused: {name} must be ({B}, {T}, {C}) {act} on "
                             f"{dev} with unit column stride, got "
                             f"{tuple(t.shape)} {t.dtype} {t.device} {t.stride()}")
        if t.data_ptr() % 16 or t.stride(0) % align or t.stride(1) % align:
            raise ValueError(f"wkv7_chunk_fused: every row of {name} must start on a "
                             f"16-byte boundary (strides {t.stride()})")
        strides += [t.stride(0), t.stride(1)]
    return strides


def wkv7_chunk_fused(state, layer: int, r, w_raw, k_raw, a_iclr, v, k_k, k_a, r_k,
                     ln_w, ln_b, elapsed, lengths, *, use_dither: bool = True,
                     precision: str = "default"):
    """Advance layer `layer` of the stacked state (L, B, N, C) by up to T tokens
    per row, in place; returns y (B, T, C) in r.dtype, zero at t >= lengths.
    r/w_raw/k_raw/a_iclr/v: (B, T, C) with unit column stride (request and token
    strides may differ: r, k, v are views of the merged R/K/V output); k_k, k_a,
    r_k, ln_w, ln_b: (C,) in r.dtype; elapsed, lengths: (B,) int32; precision:
    see bf16_mode. The kernel (launched as chunk_plan says) on CUDA tensors,
    the plain version on CPU tensors."""
    bf16 = bf16_mode("wkv7_chunk_fused", precision, state.dtype)
    if state.device.type == "cpu":
        y, new = wkv7_chunk_fused_reference(
            state[layer], r, w_raw, k_raw, a_iclr, v, k_k, k_a, r_k, ln_w, ln_b,
            elapsed, lengths, use_dither=use_dither, precision=precision)
        state[layer].copy_(new)
        return y
    if not state.is_cuda:
        raise ValueError(f"wkv7_chunk_fused: no kernel for device {state.device}")
    strides = check_chunk_operands(state, layer, r, w_raw, k_raw, a_iclr, v, k_k, k_a, r_k,
                                   ln_w, ln_b, elapsed, lengths)
    B, T, C = r.shape
    chunk_plan(B, T, C)  # raises for shapes the kernel does not take
    y = torch.empty((B, T, C), dtype=r.dtype, device=state.device)
    lib = _kernels.library("wkv7_chunk", _SIGNATURES["wkv7_chunk"])
    code = lib.wkv7_chunk_fused(
        state.data_ptr(), *(t.data_ptr() for t in (r, w_raw, k_raw, a_iclr, v)),
        k_k.data_ptr(), k_a.data_ptr(), r_k.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(),
        elapsed.data_ptr(), lengths.data_ptr(), y.data_ptr(), B, T, C, layer,
        int(use_dither), *strides, _kernels.dtype_code(r, "r"),
        _kernels.dtype_code(state, "state"), int(bf16), _kernels.stream_of(state))
    _kernels.count_launch("wkv7_chunk_fused_bf16" if bf16 else "wkv7_chunk_fused")
    _kernels.check(lib, "wkv7_chunk", "wkv7_chunk_fused", code)
    return y


def _batch_bf16(state_l, r, w_raw, k, v, a, b, elapsed, lengths, use_dither):
    """wkv7_reference_batch in the precision="bf16" arithmetic (_bf16_token)
    on a bf16 slab: the state stays bf16, rounded every token. Returns raw y
    (B, T, C) float32, zero at t >= lengths, and the new slab."""
    B, T, C = r.shape
    H = C // HEAD_SIZE
    heads = lambda x: x.to(torch.float32).reshape(B, T, H, HEAD_SIZE)
    rs, ws, ks, vs, as_, bs = (heads(x) for x in (r, w_raw, k, v, a, b))
    S = _heads_of(state_l, bf16=True)
    ys = []
    for t in range(T):
        act = (t < lengths).reshape(B, 1, 1)
        d1 = 1.0 + decay_from_raw(ws[:, t], (elapsed.to(torch.int64) + t).reshape(B, 1, 1),
                                  use_dither=use_dither)
        y, S_new = _bf16_token(S, torch.where(act, d1, 1.0), rs[:, t],
                               torch.where(act, ks[:, t], 0.0), as_[:, t],
                               torch.where(act, bs[:, t], 0.0), vs[:, t])
        S = torch.where(act[..., None], S_new, S)
        ys.append(torch.where(act, y, 0.0).reshape(B, C))
    return torch.stack(ys, dim=1), _slab_of(S, state_l)


def wkv7_batch_reference(state_l, r, w_raw, k, v, a, b, elapsed, lengths=None, *,
                         use_dither=True, precision="highest"):
    """Plain version of the bare kernel on one layer's slab, without side
    effects: ops/wkv7.wkv7_reference_batch, or _batch_bf16 under the bf16
    arithmetic (bf16_mode). Returns y (B, T, C) in r.dtype, zero at t >=
    lengths, and the new slab in state_l.dtype."""
    if bf16_mode("wkv7_batch_reference", precision, state_l.dtype):
        if lengths is None:
            lengths = torch.full((r.shape[0],), r.shape[1], dtype=torch.int32,
                                 device=r.device)
        y, new = _batch_bf16(state_l, r, w_raw, k, v, a, b, elapsed, lengths, use_dither)
    else:
        y, new = wkv7_reference_batch(state_l, r, w_raw, k, v, a, b, elapsed,
                                      use_dither=use_dither, lengths=lengths)
    return y.to(r.dtype), new


ROUNDINGS = ("none", "tf32", "3xtf32")


def _tf32_bits(x):
    """float32 x's bits as int64 in [0, 2^32)."""
    return x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _from_bits(u):
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32).view(torch.float32)


def tf32_round(x):
    """float32 x rounded to TF32's 10-bit mantissa, to nearest even."""
    u = _tf32_bits(x)
    return _from_bits((u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000)


def tf32_trunc(x):
    """float32 x as the tensor cores read a word that is not TF32: its top
    19 bits, the mantissa cut to 10 bits toward zero."""
    return _from_bits(_tf32_bits(x) & 0xFFFFE000)


def _rounded_matmul(x, y, rounding):
    """x @ y with each operand rounded as `rounding` says: "none" as they
    are; "tf32" both to TF32 (tf32_round); "3xtf32" each split hi + lo, hi =
    x cut to TF32 (tf32_trunc: one mask in the kernel), lo = x - hi (exact)
    as the tensor cores read it (tf32_trunc again), and summed lo*hi + hi*lo
    + hi*hi, the order the kernel accumulates in."""
    if rounding == "none":
        return x @ y
    if rounding == "tf32":
        return tf32_round(x) @ tf32_round(y)
    xh, yh = tf32_trunc(x), tf32_trunc(y)
    xl, yl = tf32_trunc(x - xh), tf32_trunc(y - yh)
    return xl @ yh + xh @ yl + xh @ yh


def wkv7_batch_chunked_reference(state_l, r, w_raw, k, v, a, b, elapsed, lengths=None, *,
                                 tile=16, rounding="none", use_dither=True,
                                 dtype=torch.float32):
    """The chunked WY form of wkv7_batch_reference's float32 recurrence, the
    algebra csrc/wkv7_batch.cu follows for T > 1 ("highest" and "default"),
    in plain PyTorch. Used by the tests and chip_smoke.py to size and hold
    the kernel's arithmetic; no wrapper calls it.

    Tokens go in tiles of `tile` from the state S0 (per head, row i = value,
    column j = key). Within a tile, g_t = prod_{u<=t} d1_u per column (g_-1
    = 1), A~_t = g_{t-1} a_t, R~_t = g_t r_t, K^_t = k_t / g_t, B^_t = b_t /
    g_t; M_ak = tril(A~ K^T, -1), M_ab = tril(A~ B^T, -1), M_rk = tril(R~
    K^T), M_rb = tril(R~ B^T), shared by the 64 rows; with V (64 x n) the
    tile's v:
        SA  = (S0 A~^T + V M_ak^T) (I - M_ab^T)^-1   (forward substitution)
        Y   = S0 R~^T + V M_rk^T + SA M_rb^T         (y_t = S_t r_t)
        S_n = (S0 + V K^ + SA B^) diag(g_n)
    Tokens at or past a row's length take d1 = 1 and a, b, k, r, v = 0, so
    the state stays and y is set to 0. Every matrix product's operands are
    rounded as `rounding` says (ROUNDINGS; "tf32" and "3xtf32" need dtype
    float32); the substitution and the scaling run in `dtype`.

    Shapes as wkv7_batch_reference. Returns y (B, T, C) in `dtype` and the
    new slab in state_l.dtype (rows of length 0 bit-unchanged)."""
    if rounding not in ROUNDINGS:
        raise ValueError(f"wkv7_batch_chunked_reference: unknown rounding {rounding!r}")
    if rounding != "none" and dtype != torch.float32:
        raise ValueError("wkv7_batch_chunked_reference: TF32 rounding needs float32")
    B, T, C = r.shape
    N, H = HEAD_SIZE, C // HEAD_SIZE
    if lengths is None:
        lengths = torch.full((B,), T, dtype=torch.int32, device=r.device)
    t_idx = torch.arange(T, device=r.device)
    act = (t_idx[None, :] < lengths[:, None])[:, :, None, None]  # (B, T, 1, 1)

    def heads(x):  # (B, T, C) -> (B, H, T, N), zero where inactive
        return torch.where(act, x.to(dtype).reshape(B, T, H, N), 0.0).permute(0, 2, 1, 3)

    rs, ks, vs, as_, bs = (heads(x) for x in (r, k, v, a, b))
    steps = elapsed.to(torch.int64)[:, None, None, None] + t_idx[None, :, None, None]
    d1 = 1.0 + decay_from_raw(w_raw.reshape(B, T, H, N), steps, use_dither=use_dither)
    d1 = torch.where(act, d1.to(dtype), 1.0).permute(0, 2, 1, 3)
    mm = lambda x, y: _rounded_matmul(x, y, rounding)
    S = state_l.to(dtype).reshape(B, N, H, N).permute(0, 2, 1, 3)  # (B, H, i, j)
    ys = []
    for t0 in range(0, T, tile):
        n = min(tile, T - t0)
        sl = slice(t0, t0 + n)
        # the cumulative decay in the kernel's order: a running product over
        # each 8 tokens, times g at the end of the 8 before
        g, run = [], None
        for t in range(n):
            d = d1[:, :, t0 + t]
            run = d if t % 8 == 0 else run * d
            g.append(run if t < 8 else g[t // 8 * 8 - 1] * run)
        g = torch.stack(g, dim=2)  # (B, H, n, N)
        g_prev = torch.cat([torch.ones_like(g[:, :, :1]), g[:, :, :-1]], dim=2)
        At, Rt = as_[:, :, sl] * g_prev, rs[:, :, sl] * g
        inv = 1.0 / g  # one reciprocal a token and column, as the kernel
        Kh, Bh = ks[:, :, sl] * inv, bs[:, :, sl] * inv
        M_ak = torch.tril(mm(At, Kh.transpose(-1, -2)), -1)
        M_ab = torch.tril(mm(At, Bh.transpose(-1, -2)), -1)
        M_rk = torch.tril(mm(Rt, Kh.transpose(-1, -2)))
        M_rb = torch.tril(mm(Rt, Bh.transpose(-1, -2)))
        Vt = vs[:, :, sl].transpose(-1, -2)  # (B, H, i, n)
        X = mm(S, At.transpose(-1, -2)) + mm(Vt, M_ak.transpose(-1, -2))
        SA = torch.empty_like(X)
        for u in range(n):  # column by column, as the kernel substitutes
            SA[..., u] = X[..., u]
            X[..., u + 1:] = X[..., u + 1:] + SA[..., u:u + 1] * M_ab[..., u + 1:, u][:, :, None]
        Y = mm(S, Rt.transpose(-1, -2)) + mm(Vt, M_rk.transpose(-1, -2)) \
            + mm(SA, M_rb.transpose(-1, -2))
        S = (S + mm(Vt, Kh) + mm(SA, Bh)) * g[:, :, n - 1][:, :, None, :]
        ys.append(Y.permute(0, 3, 1, 2))  # (B, n, H, i)
    y = torch.where(act, torch.cat(ys, dim=1), 0.0).reshape(B, T, C)
    new = S.permute(0, 2, 1, 3).reshape(B, N, C).to(state_l.dtype)
    return y, torch.where((lengths > 0)[:, None, None], new, state_l)


class BatchPlan(NamedTuple):
    """One of the bare kernel's three launches. `path`: "rows" (T = 1: the
    step kernel's layout, `heads_per_block` heads of one request a block,
    `rows_per_thread` state rows a thread, `threads_per_row` lanes a row),
    "wy" (T > 1, float32 state math: one block of 4 warps per (head,
    request), each warp 16 state rows as m16n8 accumulator tiles, a thread
    2 rows and a quad (4 lanes) a row; `tile_tokens` tokens a tile on the
    tensor cores in three TF32 passes a product) or "tokens" (T > 1, the
    bf16 arithmetic: the chunk kernel's layout, one block per (head,
    request), `tile_tokens` tokens a tile). The wrapper hands the plan to the
    kernel's entry, which refuses any launch but its source's."""
    path: str
    threads: int
    heads_per_block: int
    rows_per_thread: int
    threads_per_row: int
    tile_tokens: int
    grid: Tuple[int, int, int]


BATCH_PATHS = {"rows": 0, "wy": 1, "tokens": 2}


def batch_plan(B: int, T: int, C: int, precision: str) -> BatchPlan:
    """The bare kernel's launch for B requests of up to T tokens at width C
    in the arithmetic `precision` that runs: "bf16" where bf16_mode holds
    (the wrapper passes "default" for precision="bf16" on a float32 state,
    whose float32 math the JAX package runs at default dot precision),
    else "highest" or "default". As csrc/wkv7_batch.cu fixes them:
    - T = 1, either arithmetic: "rows", the step kernel's launch (step_plan);
    - T > 1, "highest" or "default": "wy", 16-token tiles, three TF32 passes
      a product in both: float32-grade products, as "highest" asks; one
      pass gained 18-22% at a 7% margin on the card (the source note);
    - T > 1, "bf16": "tokens", chunk_plan's launch (4 rows a thread, 8
      threads a row, 16-token tiles).
    Raises ValueError for shapes the kernel does not take (B is a grid
    dimension of at most 65,535) and for an unknown arithmetic."""
    if precision not in PRECISIONS:
        raise ValueError(f"wkv7_batch: unknown precision {precision!r}")
    if not 1 <= B <= 65535 or T < 1 or C < HEAD_SIZE or C % HEAD_SIZE:
        raise ValueError(f"wkv7_batch: unsupported shapes B {B}, T {T}, C {C}")
    heads = C // HEAD_SIZE
    if T == 1:
        return BatchPlan("rows", 128, 4, 16, 8, 1, (-(-heads // 4), B, 1))
    if precision == "bf16":
        return BatchPlan("tokens", 128, 1, 4, 8, 16, (heads, B, 1))
    return BatchPlan("wy", 128, 1, 2, 4, 16, (heads, B, 1))


def check_batch_operands(state, layer, r, w_raw, k, v, a, b, elapsed, lengths):
    """What the bare kernel takes, checked on the state's device: state (L,
    B, 64, H*64), 16-byte aligned; r, w_raw, k, v, a, b (B, T, C) in one
    float dtype with unit column stride, strides below 2^31; elapsed,
    lengths (B,) int32. Returns the twelve request and token strides. Raises
    TypeError, ValueError or IndexError on anything else."""
    B, T, C = r.shape
    dev, act = state.device, r.dtype
    L, _, N, _ = state.shape
    if state.shape[1] != B or state.shape[3] != C or N != HEAD_SIZE or C % HEAD_SIZE:
        raise ValueError(f"wkv7_batch: state {tuple(state.shape)} does not hold {B} rows "
                         f"of width {C} in heads of {HEAD_SIZE}")
    if not 0 <= layer < L:
        raise IndexError(f"wkv7_batch: layer {layer} out of range [0, {L})")
    _kernels.require(state, "state", device=dev, align=16)  # 16-byte row loads
    for name, t in (("elapsed", elapsed), ("lengths", lengths)):
        _kernels.require(t, name, dtype=torch.int32, shape=(B,), device=dev)
    strides = []
    for name, t in zip(("r", "w_raw", "k", "v", "a", "b"), (r, w_raw, k, v, a, b)):
        if t.dtype != act or t.device != dev or tuple(t.shape) != (B, T, C) \
                or t.stride(2) != 1 or max(t.stride(0), t.stride(1)) >= 2 ** 31:
            raise ValueError(f"wkv7_batch: {name} must be ({B}, {T}, {C}) {act} on {dev} "
                             f"with unit column stride, got {tuple(t.shape)} {t.dtype} "
                             f"{t.device} {t.stride()}")
        strides += [t.stride(0), t.stride(1)]
    return strides


def wkv7_batch(state, r, w_raw, k, v, a, b, elapsed, lengths=None, layer: int = 0, *,
               use_dither: bool = True, precision: str = "highest"):
    """The bare recurrence (the JAX wkv7_pallas_batch with `layer`): advance
    layer `layer` of the stacked state (L, B, N, C) by up to T tokens per row,
    in place, and return raw y (B, T, C) in r.dtype, zero at t >= lengths.
    r, w_raw, k (k~), v, a (-kk), b (kk*a_iclr): (B, T, C) in one dtype with
    unit column stride (request and token strides may differ); elapsed: (B,)
    int32 (token t's dither counter is elapsed + t); lengths: (B,) int32, or
    None for T everywhere; precision: see bf16_mode. The kernel (launched as
    batch_plan says) on CUDA tensors, the plain version on CPU tensors."""
    bf16 = bf16_mode("wkv7_batch", precision, state.dtype)
    B, T, C = r.shape
    if lengths is None:
        lengths = torch.full((B,), T, dtype=torch.int32, device=r.device)
    if state.device.type == "cpu":
        y, new = wkv7_batch_reference(state[layer], r, w_raw, k, v, a, b, elapsed, lengths,
                                      use_dither=use_dither, precision=precision)
        state[layer].copy_(new)
        return y
    if not state.is_cuda:
        raise ValueError(f"wkv7_batch: no kernel for device {state.device}")
    act_code = _kernels.dtype_code(r, "r")
    strides = check_batch_operands(state, layer, r, w_raw, k, v, a, b, elapsed, lengths)
    arithmetic = "bf16" if bf16 else "highest" if precision == "highest" else "default"
    plan = batch_plan(B, T, C, arithmetic)  # raises for shapes the kernel does not take
    y = torch.empty((B, T, C), dtype=r.dtype, device=state.device)
    lib = _kernels.library("wkv7_batch", _SIGNATURES["wkv7_batch"])
    code = lib.wkv7_batch(
        state.data_ptr(), *(t.data_ptr() for t in (r, w_raw, k, v, a, b)), elapsed.data_ptr(),
        lengths.data_ptr(), y.data_ptr(), B, T, C, layer, int(use_dither), *strides, act_code,
        _kernels.dtype_code(state, "state"), int(bf16), BATCH_PATHS[plan.path], plan.threads,
        plan.heads_per_block, plan.rows_per_thread, plan.threads_per_row, plan.tile_tokens,
        _kernels.stream_of(state))
    _kernels.count_launch("wkv7_batch_bf16" if bf16 else "wkv7_batch")
    _kernels.check(lib, "wkv7_batch", "wkv7_batch", code)
    return y
