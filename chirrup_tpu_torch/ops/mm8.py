"""mm8 — INT8 weight quantization and the matmuls built on it.

Quantization scheme (the rwkv pip package convention, bit-compatible with the JAX
package's ``quantize``):

    # per-column mins/ranges mx,rx over axis 0; per-row my,ry over axis 1
    w_norm = (w - my - mx) / rx / ry          in [0, 1]
    q_u8   = clip(floor(w_norm * 256), 0, 255)
    stored scales: rx/16, ry/16
    dequant: W_hat = (q_u8 + 0.5) * ry * rx + my + mx

Codes are stored signed (q_i8 = q_u8 - 128), the shift folded into the 128.5
correction constant. The matmul uses the decomposed dequantization: with
xs = x * ry,

    y = rx * (xs @ q + 0.5 * sum(xs)) + sum(x * my) + mx * sum(x)

The GEMM term runs under one of two schemes, the `core` of each matmul
(RuntimeConfig.mm8_core, named as resolve_mm8_core reads it):
- "pallas_a8" (w8a8, the default "auto"): xs quantized to int8 per row, an
  int8 x int8 -> int32 GEMM, the corrections in its epilogue;
- "pallas" (w8a16, rwkv-pip's exact scheme): xs stays in x's dtype, the codes
  are widened inside the kernel, and the corrections run here in float32.
ops/mm8_cuda.py holds the kernels and their plain versions.
"""

from __future__ import annotations

import dataclasses

import torch

from chirrup_tpu_torch.ops import mm8_cuda

# the inner int8 GEMM of the mm8 matmuls, by mm8_core name
MM8_CORES = {"auto": "pallas_a8", "pallas_a8": "pallas_a8", "pallas": "pallas"}


def resolve_mm8_core(name: str) -> str:
    """"auto" and "pallas_a8" -> "pallas_a8" (w8a8: per-row int8 activations,
    int8 x int8 -> int32 GEMM); "pallas" -> "pallas" (w8a16, the exact scheme:
    activations stay in their dtype, the codes are widened in the kernel).
    The JAX package's plain-XLA fallbacks "xla" and "xla_a8" have no
    counterpart here: their port would be the plain version on the card."""
    core = MM8_CORES.get(name)
    if core is None:
        raise ValueError(f"mm8_core {name!r} not supported: one of {sorted(MM8_CORES)}")
    return core


@dataclasses.dataclass(frozen=True)
class Mm8Weight:
    """INT8 weight for `x @ W`, W logically (K, M); with a leading layer axis
    when stacked: q (L, K, M), scales (L, M) / (L, K)."""

    q: torch.Tensor   # (..., K, M) int8, value = floor u8 code - 128
    mx: torch.Tensor  # (..., M) float32 per-column offset
    rx: torch.Tensor  # (..., M) float32 per-column scale (stored /16)
    my: torch.Tensor  # (..., K) float32 per-row offset
    ry: torch.Tensor  # (..., K) float32 per-row scale (stored /16)


@dataclasses.dataclass(frozen=True)
class Mm8MultiWeight:
    """n stacked Mm8Weights with the same input dim K merged along the output dim,
    so projections that share their token-shift inputs (TMix R/K/V) run as one
    quantize + one GEMM launch."""

    q: torch.Tensor   # (L, K, n*C) int8 — horizontally concatenated codes
    mx: torch.Tensor  # (L, n*C) float32
    rx: torch.Tensor  # (L, n*C) float32
    my: torch.Tensor  # (L, n, K) float32 per-projection row offsets
    ry: torch.Tensor  # (L, n, K) float32 per-projection row scales


@dataclasses.dataclass(frozen=True)
class LayerIndexed:
    """Layer `li` of a stacked weight, WITHOUT slicing the codes: the kernel
    reads the layer at a pointer offset into the stacked buffer."""

    w: object  # Mm8Weight or Mm8MultiWeight, stacked
    li: int


def quantize(w: torch.Tensor) -> Mm8Weight:
    """Quantize a dense (K, M) matrix. The min/max order follows the reference:
    rows > cols takes my, mx, rx, ry; otherwise mx, my, rx, ry."""
    w = w.to(torch.float32)
    if w.shape[0] > w.shape[1]:
        my = w.amin(1, keepdim=True)
        w = w - my
        mx = w.amin(0, keepdim=True)
        w = w - mx
        rx = w.amax(0, keepdim=True)
        w = w / rx
        ry = w.amax(1, keepdim=True)
        w = w / ry
    else:
        mx = w.amin(0, keepdim=True)
        w = w - mx
        my = w.amin(1, keepdim=True)
        w = w - my
        rx = w.amax(0, keepdim=True)
        w = w / rx
        ry = w.amax(1, keepdim=True)
        w = w / ry
    q_u8 = torch.clamp(torch.floor(w * 256.0), 0, 255)
    return Mm8Weight(q=(q_u8 - 128).to(torch.int8), mx=mx.reshape(-1),
                     rx=(rx / 16.0).reshape(-1), my=my.reshape(-1),
                     ry=(ry / 16.0).reshape(-1))


def quantize_stacked(w: torch.Tensor) -> Mm8Weight:
    """quantize() each layer of a stacked (L, K, M) matrix."""
    qs = [quantize(w[i]) for i in range(w.shape[0])]
    return Mm8Weight(*(torch.stack([getattr(x, f) for x in qs])
                       for f in ("q", "mx", "rx", "my", "ry")))


def dequantize(w: Mm8Weight) -> torch.Tensor:
    """W_hat = (q_u8 + 0.5) * ry*rx + my + mx, float32 (for tests)."""
    q_u8 = w.q.to(torch.float32) + 128.0
    return ((q_u8 + 0.5) * (w.ry[:, None] * 16.0) * (w.rx[None, :] * 16.0) / 256.0
            + w.my[:, None] + w.mx[None, :])


def quantize_activations(xs: torch.Tensor):
    """Per-row symmetric int8 quantization: (xs8 int8, s (B, 1) float32) with
    xs ~= xs8 * s; round half to even, as torch.round does."""
    xf = xs.to(torch.float32)
    s = mm8_cuda.row_scale(xf)
    return torch.round(xf / s).to(torch.int8), s


def merge_stacked(ws) -> Mm8MultiWeight:
    """Merge stacked (L, K, C) Mm8Weights sharing K into one Mm8MultiWeight
    (columns [W0 | W1 | ...]). All C must be equal."""
    if len({tuple(w.q.shape) for w in ws}) != 1:
        raise ValueError(f"merge_stacked: shapes differ: {[tuple(w.q.shape) for w in ws]}")
    return Mm8MultiWeight(
        q=torch.cat([w.q for w in ws], dim=-1).contiguous(),
        mx=torch.cat([w.mx for w in ws], dim=-1).contiguous(),
        rx=torch.cat([w.rx for w in ws], dim=-1).contiguous(),
        my=torch.stack([w.my for w in ws], dim=1).contiguous(),
        ry=torch.stack([w.ry for w in ws], dim=1).contiguous())


def to_k_major(w):
    """The same Mm8Weight / Mm8MultiWeight with its codes stored K-major: q
    keeps its logical (..., K, M) shape and values, each (K, M) layer with
    strides (1, K) (the storage holds (..., M, K)), as the GEMM kernels of
    both cores read them; q[layer] stays a view at a pointer offset. A
    weight that is already K-major comes back as it is."""
    q_t = w.q.transpose(-1, -2)
    if q_t.is_contiguous():
        return w
    return dataclasses.replace(w, q=q_t.contiguous().transpose(-1, -2))


def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1]).contiguous()


def mm8_matmul(x, w, *, activation=None, mul_in=None, core="auto"):
    """mm8 matmul. x: (..., K) float; w: Mm8Weight (K, M) or LayerIndexed of a
    stacked one. activation "relu2" squares the relu of the output; mul_in
    (same shape as x) multiplies x first. core: an mm8_core name
    (resolve_mm8_core). Returns (..., M) in x.dtype."""
    if resolve_mm8_core(core) == "pallas":
        return _mm8_matmul_w16(x, w, activation, mul_in)
    lead = x.shape[:-1]
    mul2 = None if mul_in is None else _rows(mul_in)
    if isinstance(w, LayerIndexed):
        s, li = w.w, w.li
        y = mm8_cuda.mm8_fused_a8(_rows(x), s.mx[li], s.rx[li], s.my[li], s.ry[li], s.q,
                                  layer=li, activation=activation, mul_in=mul2)
    else:
        y = mm8_cuda.mm8_fused_a8(_rows(x), w.mx, w.rx, w.my, w.ry, w.q,
                                  activation=activation, mul_in=mul2)
    return y.reshape(*lead, y.shape[-1])


def _mm8_matmul_w16(x, w, activation, mul_in):
    """The w8a16 matmul in the JAX package's steps (ops/mm8.py mm8_matmul):
    the gate multiplies in x's dtype; xs = x * ry*16 in float32 is rounded to
    x's dtype for the core only; the sums and the corrections stay float32."""
    if activation not in (None, "relu2"):
        raise ValueError(f"unknown mm8 activation {activation!r}")
    if mul_in is not None:
        x = x * mul_in
    if isinstance(w, LayerIndexed):
        s, layer = w.w, w.li
        mx, rx, my, ry = s.mx[layer], s.rx[layer], s.my[layer], s.ry[layer]
    else:
        s, layer = w, None
        mx, rx, my, ry = w.mx, w.rx, w.my, w.ry
    lead = x.shape[:-1]
    xf = _rows(x).to(torch.float32)
    xs_f = xf * (ry * 16.0)[None, :]
    core = mm8_cuda.mm8_core_w16(xs_f.to(x.dtype), s.q, layer=layer)
    xs_sum = xs_f.sum(-1, keepdim=True)
    x_sum = xf.sum(-1, keepdim=True)
    xmy_sum = (xf * my[None, :]).sum(-1, keepdim=True)
    y = ((rx * 16.0)[None, :] / 256.0) * (core + 128.5 * xs_sum) + xmy_sum \
        + mx[None, :] * x_sum
    if activation == "relu2":
        y = torch.square(torch.clamp_min(y, 0.0))
    return y.to(x.dtype).reshape(*lead, y.shape[-1])


def mm8_multi_matmul(x, xx, mu, w: LayerIndexed):
    """n token-shift-mixed projections y_m = (x + xx*mu[m]) @ W_m of layer w.li
    of a stacked Mm8MultiWeight. x, xx: (..., K); mu: (n, K). Returns
    (..., n*C) in x.dtype."""
    s, li = w.w, w.li
    lead = x.shape[:-1]
    y = mm8_cuda.mm8_fused_a8_multi(_rows(x), _rows(xx), mu, s.mx[li], s.rx[li],
                                    s.my[li], s.ry[li], s.q, li)
    return y.reshape(*lead, y.shape[-1])


def mm8_ffn_matmul(x, wk: LayerIndexed, wv: LayerIndexed, core="auto"):
    """The CMix pair relu(x @ Wk)^2 @ Wv on one layer: the w8a8 pair of
    kernels, or under core "pallas" two w8a16 matmuls (relu^2 on the first,
    its output in x's dtype) as the JAX package runs them."""
    if resolve_mm8_core(core) == "pallas":
        return mm8_matmul(mm8_matmul(x, wk, activation="relu2", core=core), wv, core=core)
    li = wk.li
    lead = x.shape[:-1]
    sk, sv = wk.w, wv.w
    y = mm8_cuda.mm8_fused_a8_ffn(
        _rows(x), (sk.mx[li], sk.rx[li], sk.my[li], sk.ry[li]), sk.q,
        (sv.mx[li], sv.rx[li], sv.my[li], sv.ry[li]), sv.q, li)
    return y.reshape(*lead, y.shape[-1])
