"""Parameter trees: synthetic models, and the JAX package's raw tree.

Layout: blocks stacked along a leading layer axis; all linear weights (in, out)
for `x @ W`; INT8 linears as Mm8Weight (int8 codes + float32 scales).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from chirrup_tpu_torch import resolve_device
from chirrup_tpu_torch.models.config import RWKV7Config
from chirrup_tpu_torch.ops.mm8 import Mm8Weight

_MM8_FIELDS = ("q", "mx", "rx", "my", "ry")


def _tree(dense, q8, config: RWKV7Config, *, int8_head: bool):
    L, C, V, F = config.n_layer, config.n_embd, config.vocab_size, config.d_ffn
    H, N = config.n_head, config.head_size
    Dw, Da, Dv, Dg = (config.d_decay_lora, config.d_iclr_lora, config.d_v_lora,
                      config.d_gate_lora)
    att = {
        "x_r": dense(L, C), "x_w": dense(L, C), "x_k": dense(L, C), "x_v": dense(L, C),
        "x_a": dense(L, C), "x_g": dense(L, C),
        "w0": dense(L, C), "w1": dense(L, C, Dw), "w2": dense(L, Dw, C),
        "a0": dense(L, C), "a1": dense(L, C, Da), "a2": dense(L, Da, C),
        "v0": dense(L, C), "v1": dense(L, C, Dv), "v2": dense(L, Dv, C),
        "g1": dense(L, C, Dg), "g2": dense(L, Dg, C),
        "k_k": dense(L, C, unit=True), "k_a": dense(L, C, unit=True),
        "r_k": dense(L, H, N),
        "Wr": q8(L, C, C), "Wk": q8(L, C, C), "Wv": q8(L, C, C), "Wo": q8(L, C, C),
        "ln_x_w": dense(L, C, unit=True), "ln_x_b": dense(L, C),
    }
    ffn = {"x_k": dense(L, C), "Wk": q8(L, C, F), "Wv": q8(L, F, C)}
    blocks = {"ln1_w": dense(L, C, unit=True), "ln1_b": dense(L, C),
              "ln2_w": dense(L, C, unit=True), "ln2_b": dense(L, C),
              "att": att, "ffn": ffn}
    return {"emb": dense(V, C, emb=True), "blocks": blocks,
            "ln_out_w": dense(C, unit=True), "ln_out_b": dense(C),
            "head": q8(C, V, head=True) if int8_head else dense(C, V)}


def synthetic_params(config: RWKV7Config, seed: int = 0, dtype=torch.float32,
                     scale: float = 0.5, device=None) -> Dict[str, Any]:
    """Random small-magnitude dense parameters with the real tree structure,
    generated on `device` from a torch.Generator seeded with `seed`."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def dense(*shape, unit=False, emb=False):
        s = 1.0 if emb else scale
        fan = shape[-1] if len(shape) > 1 else 1
        x = torch.randn(shape, generator=gen, device=device) * (s / fan ** 0.5)
        if unit:
            x = 1.0 + 0.1 * x
        return x.to(dtype)

    return _tree(dense, dense, config, int8_head=False)


def synthetic_params_int8(config: RWKV7Config, seed: int = 0, dtype=torch.bfloat16,
                          device=None) -> Dict[str, Any]:
    """Parameter tree with Mm8Weight big matrices (random codes, constant
    scales) — the serving-dtype synthetic model: the same compute and memory
    behaviour as a real INT8 checkpoint, generated directly on `device` from a
    torch.Generator seeded with `seed` (a dense float 7.2B tree is never built)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def dense(*shape, unit=False, emb=False):
        s = 1.0 if (unit or emb) else 0.02
        return (torch.randn(shape, generator=gen, device=device) * s).to(dtype)

    def q8(*shape, head=False):
        # head scales sized so logits concentrate like a trained model's (the
        # top candidates carry most of the softmax mass)
        rx_full, ry_full = (0.45, 1.0) if head else (0.04, 0.002)
        K, M, lead = shape[-2], shape[-1], shape[:-2]
        codes = torch.empty(shape, dtype=torch.int8, device=device)
        codes.random_(-128, 128, generator=gen)
        f32 = torch.float32
        return Mm8Weight(
            q=codes,
            mx=torch.zeros(lead + (M,), dtype=f32, device=device),
            rx=torch.full(lead + (M,), rx_full / 16, dtype=f32, device=device),
            my=torch.zeros(lead + (K,), dtype=f32, device=device),
            ry=torch.full(lead + (K,), ry_full / 16, dtype=f32, device=device))

    return _tree(dense, q8, config, int8_head=True)


def _as_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes arrays: no numpy-native bf16
        return torch.from_numpy(a.astype(np.float32)).to(device=device,
                                                         dtype=torch.bfloat16)
    # a copy: the tree's arrays may be read-only views (of JAX arrays, say)
    return torch.from_numpy(np.array(a, order="C")).to(device)


def _mm8_fields(node) -> Optional[Dict[str, Any]]:
    """The five Mm8Weight fields of node, read by key or by attribute."""
    if isinstance(node, dict):
        return node if set(node) == set(_MM8_FIELDS) else None
    if all(hasattr(node, f) for f in _MM8_FIELDS):
        return {f: getattr(node, f) for f in _MM8_FIELDS}
    return None


def params_from_numpy(tree, device=None):
    """The JAX package's raw parameter tree (nested dicts of numpy arrays, as
    synthetic_params / synthetic_params_int8 / the checkpoint loader build it)
    -> this package's tree on `device`. An Mm8Weight may arrive as an object
    or as a dict with q, mx, rx, my, ry; dtypes are kept."""
    device = resolve_device(device)
    fields = _mm8_fields(tree)
    if fields is not None:
        return Mm8Weight(**{f: _as_tensor(fields[f], device) for f in _MM8_FIELDS})
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return _as_tensor(tree, device)
