"""Model and runtime configuration for RWKV-7."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from chirrup_tpu_torch.ops.mm8 import resolve_mm8_core
from chirrup_tpu_torch.ops.wkv7_cuda import PRECISIONS as WKV_PRECISIONS

HEAD_SIZE = 64


@dataclasses.dataclass(frozen=True)
class RWKV7Config:
    """Static architecture description of an RWKV-7 "Goose" checkpoint.

    Shapes follow the public RWKV-LM checkpoint format. Published g1 sizes: 0.1B
    (L12 D768), 0.4B (L24 D1024), 1.5B (L24 D2048), 2.9B (L32 D2560), 7.2B (L32
    D4096)."""

    n_layer: int
    n_embd: int
    vocab_size: int = 65536
    head_size: int = HEAD_SIZE
    # low-rank projection widths (decay / iclr / value-residual / gate)
    d_decay_lora: int = 64
    d_iclr_lora: int = 64
    d_v_lora: int = 32
    d_gate_lora: int = 128

    @property
    def n_head(self) -> int:
        return self.n_embd // self.head_size

    @property
    def d_ffn(self) -> int:
        return self.n_embd * 4


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """How the model is executed. Whether a kernel or its plain version runs is
    decided by the device of the tensors, not here."""

    # dtype of activations and dense matmuls
    activation_dtype: torch.dtype = torch.bfloat16
    # dtype the WKV matrix state is stored in between steps (the dither
    # decorrelates its per-step rounding)
    wkv_state_dtype: torch.dtype = torch.bfloat16
    use_dither: bool = True
    # weight quantization: None (keep activation_dtype) or "int8" (mm8)
    quantization: Optional[str] = None
    # the int8 GEMM under "int8" (ops/mm8.resolve_mm8_core): "auto" =
    # "pallas_a8" (w8a8), or "pallas" (w8a16, no activation rounding in the GEMM)
    mm8_core: str = "auto"
    # candidates the sampler draws from before its exact fallback (top-p
    # coverage is checked either way; greedy rows are always exact)
    sampler_k_max: int = 128
    # the fused WKV kernels' arithmetic, the JAX package's three values:
    # "highest" and "default" carry the state in float32 within a step or
    # chunk; "bf16" on a bf16 state keeps it in bf16 through every
    # elementwise operation and applies the delta form S += S*d + v k^T +
    # sa b^T (d = decay, the reference fp16 kernel's scheme, which keeps slow
    # decays that S * (1 + d) would round away), rounding the state every
    # token; on a float32 state "bf16" is "default"
    # (ops/wkv7_cuda.bf16_mode)
    wkv_precision: str = "default"

    def __post_init__(self):
        resolve_mm8_core(self.mm8_core)
        if self.wkv_precision not in WKV_PRECISIONS:
            raise ValueError(f"wkv_precision must be one of {WKV_PRECISIONS}, "
                             f"got {self.wkv_precision!r}")
