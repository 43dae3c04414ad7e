"""mm8 — INT8 weight quantization and the w8a8 matmul built on it.

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

and runs the GEMM term in int8 x int8 -> int32 on per-row int8 activations
(w8a8): ops/mm8_cuda.py holds the kernels and their plain versions.
"""

from __future__ import annotations

import dataclasses

import torch

from chirrup_tpu_torch.ops import mm8_cuda


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


def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1]).contiguous()


def mm8_matmul(x, w, *, activation=None, mul_in=None):
    """w8a8 matmul. x: (..., K) float; w: Mm8Weight (K, M) or LayerIndexed of a
    stacked one. activation "relu2" squares the relu of the output; mul_in
    (same shape as x) multiplies x before quantization. Returns (..., M) in
    x.dtype."""
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


def mm8_multi_matmul(x, xx, mu, w: LayerIndexed):
    """n token-shift-mixed projections y_m = (x + xx*mu[m]) @ W_m of layer w.li
    of a stacked Mm8MultiWeight. x, xx: (..., K); mu: (n, K). Returns
    (..., n*C) in x.dtype."""
    s, li = w.w, w.li
    lead = x.shape[:-1]
    y = mm8_cuda.mm8_fused_a8_multi(_rows(x), _rows(xx), mu, s.mx[li], s.rx[li],
                                    s.my[li], s.ry[li], s.q, li)
    return y.reshape(*lead, y.shape[-1])


def mm8_ffn_matmul(x, wk: LayerIndexed, wv: LayerIndexed):
    """The CMix pair relu(x @ Wk)^2 @ Wv, both w8a8, on one layer."""
    li = wk.li
    lead = x.shape[:-1]
    sk, sv = wk.w, wv.w
    y = mm8_cuda.mm8_fused_a8_ffn(
        _rows(x), (sk.mx[li], sk.rx[li], sk.my[li], sk.ry[li]), sk.q,
        (sv.mx[li], sv.rx[li], sv.my[li], sv.ry[li]), sv.q, li)
    return y.reshape(*lead, y.shape[-1])
