"""Linear-layer dispatch: dense (bf16/fp32) or INT8 (mm8) matmul.

All model weights are stored for right-multiplication `x @ W` with W shaped
(in_features, out_features).
"""

from __future__ import annotations

import torch

from chirrup_tpu_torch.ops.mm8 import LayerIndexed, Mm8Weight, mm8_matmul


def matmul(x, w, *, activation=None, mul_in=None, mm8_core="auto"):
    """x @ w; w is a dense tensor, an Mm8Weight, or a LayerIndexed view of a
    stacked Mm8Weight. `activation` ("relu2") is an output epilogue; `mul_in`
    an elementwise input multiplier (the TMix output gate); `mm8_core` the
    int8 GEMM of an INT8 w (ops/mm8.resolve_mm8_core)."""
    if activation not in (None, "relu2"):
        raise ValueError(f"unknown activation {activation!r}")
    if isinstance(w, (Mm8Weight, LayerIndexed)):
        return mm8_matmul(x, w, activation=activation, mul_in=mul_in, core=mm8_core)
    if mul_in is not None:
        x = x * mul_in
    y = torch.matmul(x, w.to(x.dtype))
    if activation == "relu2":
        y = torch.square(torch.relu(y))
    return y
