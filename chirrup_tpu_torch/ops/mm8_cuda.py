"""The mm8 matmul kernels (csrc/mm8_a8.cu, csrc/mm8_w16.cu) and their plain
PyTorch versions.

Two kernels carry every int8 matmul of the w8a8 scheme (mm8_core "pallas_a8"):

- ``quant_rows``: per-row int8 quantization of x*ry*16 (x optionally mixed as
  x + xx*mu[m] for each of n variants, or gated as x*mul) plus the four row
  statistics [s, sum xs, sum x, sum x*my] of the decomposed dequantization,
  in one pass with the row in registers; ``quant_plan`` picks its launch
  shape (threads and elements a thread);
- ``gemm``: int8 x int8 -> int32 on the tensor cores (TMA-fed wgmma), then
  y = rx*16/256 * (s*acc + 128.5*sum xs) + sum x*my + mx*sum x, with an optional
  relu^2, written in bfloat16 or float32 (or acc itself, for exactness checks).
  On CUDA it takes the codes K-major only: each layer (K, M) with strides
  (1, K), as ``mm8.to_k_major`` stores them (wgmma reads 8-bit operands
  K-major); anything else raises. ``gemm_plan`` picks its tiles.

The compositions below (single, merged multi-projection, relu^2 FFN pair) are
the port of the JAX package's fused a8 Pallas kernels; ``mm8_core_a8`` is the
bare int8 core (the JAX ``mm8_core_pallas_a8``), ``gemm``'s int32 output.

The exact w8a16 scheme (mm8_core "pallas") has one kernel, ``mm8_core_w16``:
xs (B, K) bf16 or float32 times the int8 codes (K, M) -> float32, only the
``xs @ q`` term (ops/mm8.py applies the corrections). On CUDA it too takes
the codes K-major only; bf16 xs runs a TMA-fed wgmma GEMM on the codes
widened to bf16 in shared memory, whose tiles ``w16_plan`` picks.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from chirrup_tpu_torch.ops import _kernels

_SOURCE = "mm8_a8"
_P, _I = _kernels.P, _kernels.I
_SIGNATURES = {
    "mm8_a8_quant_rows": [_P] * 7 + [_I] * 7 + [_P],
    "mm8_a8_codes_map": [_P] + [_I] * 4 + [_P],
    "mm8_a8_gemm": [_P] * 6 + [_I] * 11 + [_P],
}
_W16_SOURCE = "mm8_w16"
_W16_SIGNATURES = {
    "mm8_w16_codes_map": [_P] + [_I] * 4 + [_P],
    "mm8_w16_gemm": [_P] * 4 + [_I] * 9 + [_P],
}

# the w8a8 GEMM's tiles (csrc/mm8_a8.cu): K in 128-byte stages; (bm, bn) ->
# pipeline stages. B > A8_DECODE_ROWS takes a 128-row prefill tile, 256
# columns wide unless 128 fills the card's waves of one CTA per SM better;
# B <= A8_DECODE_ROWS the decode tile, with K split across a cluster of up
# to A8_MAX_SPLIT CTAs until the grid has A8_MIN_CTAS CTAs.
A8_BK = 128
A8_TILES = {(128, 256): 4, (128, 128): 6, (64, 128): 4}
A8_DECODE_ROWS = 64
A8_MIN_CTAS = 128
A8_MAX_SPLIT = 4
H100_SMS = 132

# the w8a16 GEMM's tiles (csrc/mm8_w16.cu): K in 128-deep stages; (bm, bn) ->
# pipeline stages. Prefill tiles are chosen as the w8a8 GEMM's; B <=
# A8_DECODE_ROWS takes the decode tile, two CTAs per SM, with K split across a
# cluster of up to A8_MAX_SPLIT CTAs until the grid has W16_MIN_CTAS CTAs.
W16_BK = 128
W16_TILES = {(128, 256): 2, (128, 128): 4, (64, 128): 2}
W16_MIN_CTAS = 256

_OUT_MODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}


# ------------------------------------------------------------ plain versions

def row_scale(xs: torch.Tensor) -> torch.Tensor:
    """s = max(max|xs| / 127, 1e-20) per row, (..., 1) float32. The divisor is
    a tensor on purpose: PyTorch's CUDA division by a Python scalar multiplies
    by its rounded reciprocal, which is not the IEEE division that the JAX
    package and the kernel use, and can move s by one ulp."""
    amax = xs.abs().amax(-1, keepdim=True)
    return torch.clamp_min(amax / torch.full_like(amax, 127.0), 1e-20)


def quant_rows_reference(x, ry, my, *, xx=None, mu=None, mul=None):
    """x: (B, K); ry, my: (n, K) float32; xx with mu (n, K) -> n mixed variants
    x + xx*mu[m]; mul -> x*mul (n = 1). Returns (x8 (n, B, K) int8, stats
    (n, B, 4) float32 [s, sum xs, sum x, sum x*my])."""
    xf = x.to(torch.float32)
    if xx is not None:
        xm = xf[None] + xx.to(torch.float32)[None] * mu.to(torch.float32)[:, None, :]
    elif mul is not None:
        xm = (xf * mul.to(torch.float32))[None]
    else:
        xm = xf[None]
    xs = xm * (ry * 16.0)[:, None, :]
    s = row_scale(xs)
    x8 = torch.round(xs / s).to(torch.int8)
    stats = torch.cat([s, xs.sum(-1, keepdim=True), xm.sum(-1, keepdim=True),
                       (xm * my[:, None, :]).sum(-1, keepdim=True)], dim=-1)
    return x8, stats


def gemm_acc_reference(x8, q):
    """Exact int32 x8 @ q through float64 (integer sums far below 2^53)."""
    return torch.matmul(x8.to(torch.float64), q.to(torch.float64)).to(torch.int32)


def core_w16_reference(xs, q):
    """xs (B, K) float x q (K, M) int8 -> (B, M) float32 with float32
    accumulation. Widening bf16 xs and the codes to float32 is exact, so
    every product is exact and only the sums round, as in the kernel."""
    return torch.matmul(xs.to(torch.float32), q.to(torch.float32))


def gemm_reference(x8, stats, q, mx, rx, *, relu2=False, out_dtype=torch.bfloat16):
    """x8 (n, B, K), stats (n, B, 4), q (K, M) with M = n * C: variant m feeds
    columns [m*C, (m+1)*C). Returns (B, M) in out_dtype (int32: raw acc)."""
    n, B, K = x8.shape
    M = q.shape[1]
    C = M // n
    outs = []
    for m in range(n):
        acc = gemm_acc_reference(x8[m], q[:, m * C:(m + 1) * C])
        if out_dtype == torch.int32:
            outs.append(acc)
            continue
        st = stats[m]
        y = ((rx[m * C:(m + 1) * C] * 0.0625)
             * (acc.to(torch.float32) * st[:, 0:1] + 128.5 * st[:, 1:2])
             + st[:, 3:4] + mx[m * C:(m + 1) * C] * st[:, 2:3])
        if relu2:
            y = torch.clamp_min(y, 0.0)
            y = y * y
        outs.append(y.to(out_dtype))
    return torch.cat(outs, dim=-1)


# ------------------------------------------------------------------ wrappers

class QuantPlan(NamedTuple):
    """The quantizer's launch: one CTA per (variant, row), grid (n, B, 1), of
    `threads` threads, each holding `elems` (8, 16 or 32) elements of the row
    in registers (8-element chunks t, t + threads, ...)."""
    threads: int
    elems: int
    grid: Tuple[int, int, int]


QUANT_MAX_THREADS = {8: 1024, 16: 1024, 32: 512}  # the kernel's launch bounds by elems
QUANT_PREFILL_ROWS = 256  # from here up a thread holds 32 elements


def quant_shape(n: int, B: int, K: int, elems: int) -> QuantPlan:
    """The launch that quantizes n variants of B rows of K at `elems`
    elements a thread: each row in 8-element chunks, in whole warps. Raises
    ValueError where the kernel has no such launch."""
    if n < 1 or B < 1 or K < 1 or K % 8:
        raise ValueError(f"quant_rows: unsupported shapes n {n}, B {B}, K {K} "
                         f"(K % 8 == 0 required: 16-byte row loads)")
    if elems not in QUANT_MAX_THREADS:
        raise ValueError(f"quant_rows: no launch with {elems} elements a thread")
    threads = -(-(K // 8) // (32 * (elems // 8))) * 32  # whole warps
    if threads > QUANT_MAX_THREADS[elems]:
        raise ValueError(f"quant_rows: {K} elements at {elems} a thread take more "
                         f"than {QUANT_MAX_THREADS[elems]} threads")
    return QuantPlan(threads=threads, elems=elems, grid=(n, B, 1))


@functools.lru_cache(maxsize=None)
def quant_plan(n: int, B: int, K: int) -> QuantPlan:
    """The quantizer's launch for n variants of B rows of K, the fastest
    measured on the H100: below QUANT_PREFILL_ROWS rows (decode) 8 elements
    a thread, 16 for the merged R/K/V and above K = 4,096; from there up
    (prefill) 32, so that one block reduction serves 32 codes a thread."""
    elems = 32 if B >= QUANT_PREFILL_ROWS else 16 if K > 4096 or n == 3 else 8
    return quant_shape(n, B, K, elems)


def check_quant_operands(x, ry, my, *, xx=None, mu=None, mul=None):
    """What the quantizer kernel takes, checked on x's device: x (B, K) float32
    or bfloat16; ry, my (n, K) float32; xx with mu (n, K), or mul (n = 1), in
    x's dtype; every tensor contiguous and 16-byte aligned. Returns (mode,
    aux): mode 0 plain, 1 mixed, 2 gated; aux the xx or mul tensor, or None.
    Raises TypeError or ValueError on anything else."""
    if x.dim() != 2:
        raise ValueError(f"quant_rows: x must be (B, K), got {tuple(x.shape)}")
    B, K = x.shape
    n = ry.shape[0] if ry.dim() == 2 else -1
    dev = x.device
    _kernels.dtype_code(x, "x")
    _kernels.require(x, "x", device=dev, align=16)
    _kernels.require(ry, "ry", dtype=torch.float32, shape=(n, K), device=dev, align=16)
    _kernels.require(my, "my", dtype=torch.float32, shape=(n, K), device=dev, align=16)
    mode, aux = 0, None
    if xx is not None:
        mode, aux = 1, xx
        if mu is None:
            raise ValueError("quant_rows: xx needs mu")
        _kernels.require(mu, "mu", dtype=x.dtype, shape=(n, K), device=dev, align=16)
    elif mul is not None:
        if n != 1:
            raise ValueError("quant_rows: mul takes one variant")
        mode, aux = 2, mul
    if aux is not None:
        _kernels.require(aux, "xx/mul", dtype=x.dtype, shape=(B, K), device=dev, align=16)
    return mode, aux


def quant_rows(x, ry, my, *, xx=None, mu=None, mul=None):
    """See quant_rows_reference. The kernel on CUDA tensors (launched as
    quant_plan says), the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return quant_rows_reference(x, ry, my, xx=xx, mu=mu, mul=mul)
    if not x.is_cuda:
        raise ValueError(f"quant_rows: no kernel for device {x.device}")
    return quant_rows_planned(None, x, ry, my, xx=xx, mu=mu, mul=mul)


def quant_rows_planned(plan: Optional[QuantPlan], x, ry, my, *, xx=None, mu=None,
                       mul=None):
    """quant_rows' kernel on CUDA tensors with a given launch (quant_shape),
    or quant_plan's when `plan` is None; any launch gives the same codes and
    s, and sums within their reordering bound."""
    mode, aux = check_quant_operands(x, ry, my, xx=xx, mu=mu, mul=mul)
    B, K = x.shape
    n = ry.shape[0]
    dev = x.device
    if plan is None:
        plan = quant_plan(n, B, K)
    x8 = torch.empty((n, B, K), dtype=torch.int8, device=dev)
    stats = torch.empty((n, B, 4), dtype=torch.float32, device=dev)
    lib = _kernels.library(_SOURCE, _SIGNATURES)
    err = lib.mm8_a8_quant_rows(
        x.data_ptr(), None if aux is None else aux.data_ptr(),
        mu.data_ptr() if mode == 1 else None, ry.data_ptr(), my.data_ptr(), x8.data_ptr(),
        stats.data_ptr(), B, K, n, mode, _kernels.dtype_code(x, "x"), plan.threads,
        plan.elems, _kernels.stream_of(x))
    _kernels.count_launch("mm8_a8_quant_rows")
    _kernels.check(lib, _SOURCE, "mm8_a8_quant_rows", err)
    return x8, stats


class GemmPlan(NamedTuple):
    """The w8a8 GEMM's launch: (bm, bn) tiles with `stages` pipeline stages,
    K split across the `split` CTAs of a cluster (rank r sums k_slices[r]),
    grid (split * row tiles, column tiles, 1), as the kernel's host side
    forms it from the same four numbers."""
    bm: int
    bn: int
    stages: int
    split: int
    grid: Tuple[int, int, int]
    k_slices: Tuple[Tuple[int, int], ...]


def _wave_fill(ctas: int, sms: int) -> float:
    """The busy share of `sms` SMs over the waves of `ctas` one-per-SM CTAs."""
    return ctas / (-(-ctas // sms) * sms)


@functools.lru_cache(maxsize=None)
def gemm_plan(n: int, B: int, K: int, M: int, q_strides, sms: int = H100_SMS) -> GemmPlan:
    """The tile configuration of the w8a8 GEMM for x8 (n, B, K) times the
    codes of one layer, logically (K, M) with strides `q_strides`, on a card
    of `sms` SMs. Raises ValueError for N-major codes (strides other than
    (1, K)), K % 128 != 0, or a variant width M / n that is not a multiple
    of 128."""
    if tuple(q_strides) != (1, K):
        raise ValueError(f"gemm: the codes must be K-major, strides (1, {K}) "
                         f"(mm8.to_k_major), got {tuple(q_strides)}")
    if n < 1 or M % n:
        raise ValueError(f"gemm: {M} columns do not split into {n} variants")
    width = M // n
    if K % A8_BK or K == 0 or width % 128 or B < 1:
        raise ValueError(f"gemm: unsupported shapes B {B}, K {K}, M {M}, {n} variants "
                         f"(K % {A8_BK} == 0 and each variant's width % 128 == 0 required)")
    bm, bn = (64, 128) if B <= A8_DECODE_ROWS else (128, _prefill_bn(B, M, width, sms))
    return _split_plan(bm, bn, A8_TILES[(bm, bn)], B, K, M, A8_MIN_CTAS)


def _prefill_bn(B: int, M: int, width: int, sms: int) -> int:
    """The prefill tile's width: 256 columns unless the variant width is not
    a multiple of 256 or 128 fills the waves of one CTA per SM on `sms` SMs
    clearly better."""
    rows = -(-B // 128)
    if width % 256 or (_wave_fill(rows * M // 256, sms)
                       < _wave_fill(rows * M // 128, sms) - 0.1):
        return 128
    return 256


def _split_plan(bm: int, bn: int, stages: int, B: int, K: int, M: int,
                min_ctas: int) -> GemmPlan:
    """The plan of (bm, bn) tiles over (B, K) x (K, M): at decode row counts
    (B <= A8_DECODE_ROWS) K is split across a cluster of 2, then 4 CTAs while
    the grid has fewer than `min_ctas` CTAs and each slice stays whole
    128-deep stages."""
    rows, cols, blocks = -(-B // bm), M // bn, K // A8_BK
    split = 1
    if B <= A8_DECODE_ROWS:
        while (cols * split < min_ctas and split < A8_MAX_SPLIT
               and blocks % (2 * split) == 0):
            split *= 2
    per = K // split
    return GemmPlan(bm=bm, bn=bn, stages=stages, split=split, grid=(split * rows, cols, 1),
                    k_slices=tuple((r * per, (r + 1) * per) for r in range(split)))


@functools.lru_cache(maxsize=None)
def w16_plan(B: int, K: int, M: int, q_strides, sms: int = H100_SMS) -> GemmPlan:
    """The tile configuration of the w8a16 GEMM for xs (B, K) times the codes
    of one layer, logically (K, M) with strides `q_strides`, on a card of
    `sms` SMs: at B <= 64 the 64 x 128 decode tile, K split until the grid
    has W16_MIN_CTAS CTAs; above, 128 x 256 or 128 x 128 by the w8a8 GEMM's
    rule. Raises ValueError for N-major codes (strides other than (1, K)),
    K % 128 != 0, M % 128 != 0 or no rows."""
    if tuple(q_strides) != (1, K):
        raise ValueError(f"mm8_core_w16: the codes must be K-major, strides (1, {K}) "
                         f"(mm8.to_k_major), got {tuple(q_strides)}")
    if K % W16_BK or K == 0 or M % 128 or M == 0 or B < 1:
        raise ValueError(f"mm8_core_w16: unsupported shapes B {B}, K {K}, M {M} "
                         f"(K % {W16_BK} == 0 and M % 128 == 0 required)")
    bm, bn = (64, 128) if B <= A8_DECODE_ROWS else (128, _prefill_bn(B, M, M, sms))
    return _split_plan(bm, bn, W16_TILES[(bm, bn)], B, K, M, W16_MIN_CTAS)


# tensor maps of code tensors, by (address, shape, box): a map holds only
# those, so it stays right for whatever tensor later has the same address
_CODE_MAPS = {}


def _codes_map(lib, source: str, ptr: int, L: int, K: int, M: int, bn: int):
    """The tensor map of K-major codes at `ptr`, encoded by `source`'s
    library (both GEMMs encode the same map, so either's serves both)."""
    key = (ptr, L, K, M, bn)
    buf = _CODE_MAPS.get(key)
    if buf is None:
        buf = ctypes.create_string_buffer(128)
        fn = f"{source}_codes_map"
        _kernels.check(lib, source, fn, getattr(lib, fn)(ptr, L, K, M, bn, buf))
        _CODE_MAPS[key] = buf
    return buf


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def gemm(x8, stats, q, mx, rx, *, layer: Optional[int] = None, relu2=False,
         out_dtype=torch.bfloat16):
    """See gemm_reference. q is (K, M), or the stacked (L, K, M) codes with
    `layer`: the kernel then reads that layer through a coordinate of its
    tensor map (no copy). On CUDA the codes must be K-major (mm8.to_k_major):
    q[layer] with strides (1, K). mx, rx: (M,) float32 of the same layer.
    out_dtype torch.int32 returns the raw accumulators."""
    if layer is not None:
        q_layer = q[layer]  # a view: no copy on either path
    else:
        q_layer = q
    if x8.device.type == "cpu":
        return gemm_reference(x8, stats, q_layer, mx, rx, relu2=relu2,
                              out_dtype=out_dtype)
    if not x8.is_cuda:
        raise ValueError(f"gemm: no kernel for device {x8.device}")
    n, B, K = x8.shape
    K2, M = q_layer.shape
    if K2 != K:
        raise ValueError(f"gemm: x8 has K {K}, the codes {K2}")
    dev = x8.device
    plan = gemm_plan(n, B, K, M, q_layer.stride(), _sm_count(dev))
    L = 1 if layer is None else q.shape[0]
    if (q.dtype != torch.int8 or q.device != dev or q.data_ptr() % 16
            or (L > 1 and q.stride(0) != K * M)):
        raise ValueError(f"gemm: the codes must be int8 on {dev}, layers K*M apart, "
                         f"16-byte aligned")
    _kernels.require(x8, "x8", dtype=torch.int8, device=dev, align=16)
    _kernels.require(stats, "stats", dtype=torch.float32, shape=(n, B, 4), device=dev,
                     align=16)
    _kernels.require(mx, "mx", dtype=torch.float32, shape=(M,), device=dev, align=8)
    _kernels.require(rx, "rx", dtype=torch.float32, shape=(M,), device=dev, align=8)
    if out_dtype not in _OUT_MODES:
        raise TypeError(f"gemm: out_dtype {out_dtype} not supported")
    out = torch.empty((B, M), dtype=out_dtype, device=dev)
    lib = _kernels.library(_SOURCE, _SIGNATURES)
    qmap = _codes_map(lib, _SOURCE, q.data_ptr(), L, K, M, plan.bn)
    err = lib.mm8_a8_gemm(
        x8.data_ptr(), stats.data_ptr(), qmap, mx.data_ptr(), rx.data_ptr(), out.data_ptr(),
        B, K, M, n, 0 if layer is None else layer, _OUT_MODES[out_dtype], int(relu2),
        plan.bm, plan.bn, plan.stages, plan.split, _kernels.stream_of(x8))
    _kernels.count_launch("mm8_a8_gemm")
    _kernels.check(lib, _SOURCE, "mm8_a8_gemm", err)
    return out


def mm8_core_w16(xs, q, *, layer: Optional[int] = None):
    """xs @ q for the w8a16 mm8 matmul: xs (B, K) bfloat16 or float32, q the
    (K, M) int8 codes, or the stacked (L, K, M) codes with `layer` (read in
    place, no copy). Returns (B, M) float32. The kernel on CUDA tensors, with
    the codes K-major (mm8.to_k_major; w16_plan names the shapes it takes),
    the plain version on CPU tensors."""
    q_layer = q if layer is None else q[layer]  # a view: no copy on either path
    if xs.device.type == "cpu":
        return core_w16_reference(xs, q_layer)
    if not xs.is_cuda:
        raise ValueError(f"mm8_core_w16: no kernel for device {xs.device}")
    B, K = xs.shape
    K2, M = q_layer.shape
    if K2 != K:
        raise ValueError(f"mm8_core_w16: xs has K {K}, the codes {K2}")
    dev = xs.device
    plan = w16_plan(B, K, M, q_layer.stride(), _sm_count(dev))
    L = 1 if layer is None else q.shape[0]
    if (q.dtype != torch.int8 or q.device != dev or q.data_ptr() % 16
            or (L > 1 and q.stride(0) != K * M)):
        raise ValueError(f"mm8_core_w16: the codes must be int8 on {dev}, layers K*M "
                         f"apart, 16-byte aligned")
    _kernels.require(xs, "xs", device=dev, align=16)
    code = _kernels.dtype_code(xs, "xs")
    out = torch.empty((B, M), dtype=torch.float32, device=dev)
    lib = _kernels.library(_W16_SOURCE, _W16_SIGNATURES)
    qmap = _codes_map(lib, _W16_SOURCE, q.data_ptr(), L, K, M, plan.bn) if code == 1 else None
    err = lib.mm8_w16_gemm(xs.data_ptr(), qmap, q_layer.data_ptr(), out.data_ptr(), B, K, M,
                           0 if layer is None else layer, code, plan.bm, plan.bn, plan.stages,
                           plan.split, _kernels.stream_of(xs))
    _kernels.count_launch("mm8_w16_gemm")
    _kernels.check(lib, _W16_SOURCE, "mm8_w16_gemm", err)
    return out


def mm8_core_a8(xs8, q, *, layer: Optional[int] = None):
    """The bare w8a8 core: xs8 (B, K) int8 x q (K, M) int8, or the stacked
    (L, K, M) codes with `layer`, -> exact (B, M) int32. ``gemm`` in its int32
    output mode, so on CUDA the codes must be K-major as there (mm8.to_k_major);
    no serving path of either package calls it."""
    B, M = xs8.shape[0], q.shape[-1]
    zeros = lambda *s: torch.zeros(s, dtype=torch.float32, device=xs8.device)
    return gemm(xs8[None], zeros(1, B, 4), q, zeros(M), zeros(M), layer=layer,
                out_dtype=torch.int32)


# -------------------------------------------------------------- compositions

def mm8_fused_a8(x, mx, rx, my, ry, q, *, layer: Optional[int] = None,
                 activation=None, mul_in=None):
    """One w8a8 mm8 matmul: (B, K) float x (K, M) int8 -> (B, M) in x.dtype.
    Scale vectors are the Mm8Weight fields of the layer (rx, ry stored /16);
    mul_in: optional (B, K) input multiplier (the TMix gate)."""
    if activation not in (None, "relu2"):
        raise ValueError(f"unknown mm8 activation {activation!r}")
    x8, stats = quant_rows(x, ry[None], my[None], mul=mul_in)
    return gemm(x8, stats, q, mx, rx, layer=layer, relu2=activation == "relu2",
                out_dtype=x.dtype)


def mm8_fused_a8_multi(x, xx, mu, mx, rx, my, ry, q, layer: int):
    """n token-shift-mixed projections off one (x, xx) pair:
    y[:, m*C:(m+1)*C] = (x + xx*mu[m]) @ W_m. mu, my, ry: (n, K); mx, rx: (n*C,);
    q: stacked (L, K, n*C) codes. Returns (B, n*C) in x.dtype."""
    x8, stats = quant_rows(x, ry, my, xx=xx, mu=mu)
    return gemm(x8, stats, q, mx, rx, layer=layer, out_dtype=x.dtype)


def mm8_fused_a8_ffn(x, k_scales: Tuple, qk, v_scales: Tuple, qv, layer: int):
    """relu(mm8(x, Wk))^2 then mm8 with Wv, both w8a8. The (B, F) intermediate
    is rounded to bfloat16 before its quantization, whatever x's dtype (the JAX
    kernel keeps it in a bf16 scratch). *_scales = (mx, rx, my, ry) of the layer."""
    kmx, krx, kmy, kry = k_scales
    vmx, vrx, vmy, vry = v_scales
    x8, stats = quant_rows(x, kry[None], kmy[None])
    h = gemm(x8, stats, qk, kmx, krx, layer=layer, relu2=True,
             out_dtype=torch.bfloat16)
    h8, hstats = quant_rows(h, vry[None], vmy[None])
    return gemm(h8, hstats, qv, vmx, vrx, layer=layer, out_dtype=x.dtype)
