"""Parameter trees: RWKV-LM `.pth` checkpoints, synthetic models, and the JAX
package's raw tree.

Layout: blocks stacked along a leading layer axis; all linear weights (in, out)
for `x @ W`; INT8 linears as Mm8Weight (int8 codes + float32 scales).

A `.pth` is the flat RWKV-LM state dict of the public RWKV-7 checkpoints. It is
prepared as the JAX package's loader prepares it, in float32 numpy, so both
give the same tree bit for bit: ln0 folded into the embedding, the five
(out, in) linears transposed to (in, out), block 0's absent v-LoRA replaced
by zeros of the other layers' shape. Native checkpoint directories (the
prepared tree on disk) are models/checkpoint.py.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from chirrup_tpu_torch import resolve_device
from chirrup_tpu_torch.models.config import RWKV7Config
from chirrup_tpu_torch.ops.mm8 import MM8_FIELDS, Mm8Weight, mm8_fields
from chirrup_tpu_torch.parallel.tp import shard_params


def load_state_dict_pth(path: str) -> Dict[str, np.ndarray]:
    """A `.pth` state dict as float32 numpy arrays (read on the CPU; no code
    in the file runs: weights_only)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.float().numpy() for k, v in sd.items()}


def infer_config(sd: Dict[str, np.ndarray], vocab_size: Optional[int] = None) -> RWKV7Config:
    """The architecture from the checkpoint's keys and shapes; d_v_lora from
    block 1 (block 0 has no value residual)."""
    n_head, head_size = sd["blocks.0.att.r_k"].shape
    n_layer = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("blocks."))
    att0 = "blocks.0.att."
    return RWKV7Config(
        n_layer=n_layer,
        n_embd=n_head * head_size,
        vocab_size=vocab_size or sd["emb.weight"].shape[0],
        head_size=head_size,
        d_decay_lora=sd[att0 + "w1"].shape[1],
        d_iclr_lora=sd[att0 + "a1"].shape[1],
        d_v_lora=sd["blocks.1.att.v1"].shape[1] if n_layer > 1 else sd[att0 + "a1"].shape[1],
        d_gate_lora=sd[att0 + "g1"].shape[1],
    )


def _layer_norm_np(x, w, b, eps=1e-5):
    mu = x.mean(-1, keepdims=True)
    var = ((x - mu) ** 2).mean(-1, keepdims=True)
    return (x - mu) / np.sqrt(var + eps) * w + b


def params_from_state_dict(sd: Dict[str, np.ndarray], config: RWKV7Config,
                           dtype=torch.float32, device=None) -> Dict[str, Any]:
    """The stacked-blocks tree of a state dict, each leaf moved to `device`
    (the CUDA device unless one is given) as soon as it is stacked."""
    device = resolve_device(device)
    L, C, Dv = config.n_layer, config.n_embd, config.d_v_lora

    def get(k):
        return np.asarray(sd[k], np.float32)

    def vec(k):
        return get(k).reshape(-1)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    def stack(fn):
        return put(np.stack([fn(i) for i in range(L)]))

    def att(name):
        return lambda i: get(f"blocks.{i}.att.{name}")

    def att_vec(name):
        return lambda i: vec(f"blocks.{i}.att.{name}")

    def att_t(name):
        return lambda i: get(f"blocks.{i}.att.{name}").T

    def v_lora(name, shape):
        # block 0 may carry no v0/v1/v2 (its value residual is unused): zeros
        # of the other layers' shape keep the stack uniform
        def fn(i):
            key = f"blocks.{i}.att.{name}"
            if key in sd:
                return get(key).squeeze() if name == "v0" else get(key)
            return np.zeros(shape, np.float32)
        return fn

    emb = _layer_norm_np(get("emb.weight"), vec("blocks.0.ln0.weight"),
                         vec("blocks.0.ln0.bias"))
    attn = {k: stack(att_vec(k)) for k in ("x_r", "x_w", "x_k", "x_v", "x_a", "x_g",
                                           "w0")}
    attn.update({
        "w1": stack(att("w1")), "w2": stack(att("w2")),
        "a0": stack(att_vec("a0")), "a1": stack(att("a1")), "a2": stack(att("a2")),
        "v0": stack(v_lora("v0", (C,))), "v1": stack(v_lora("v1", (C, Dv))),
        "v2": stack(v_lora("v2", (Dv, C))),
        "g1": stack(att("g1")), "g2": stack(att("g2")),
        "k_k": stack(att_vec("k_k")), "k_a": stack(att_vec("k_a")),
        "r_k": stack(att("r_k")),
        "Wr": stack(att_t("receptance.weight")), "Wk": stack(att_t("key.weight")),
        "Wv": stack(att_t("value.weight")), "Wo": stack(att_t("output.weight")),
        "ln_x_w": stack(att_vec("ln_x.weight")), "ln_x_b": stack(att_vec("ln_x.bias")),
    })
    ffn = {
        "x_k": stack(lambda i: vec(f"blocks.{i}.ffn.x_k")),
        "Wk": stack(lambda i: get(f"blocks.{i}.ffn.key.weight").T),
        "Wv": stack(lambda i: get(f"blocks.{i}.ffn.value.weight").T),
    }
    blocks = {
        "ln1_w": stack(lambda i: vec(f"blocks.{i}.ln1.weight")),
        "ln1_b": stack(lambda i: vec(f"blocks.{i}.ln1.bias")),
        "ln2_w": stack(lambda i: vec(f"blocks.{i}.ln2.weight")),
        "ln2_b": stack(lambda i: vec(f"blocks.{i}.ln2.bias")),
        "att": attn, "ffn": ffn,
    }
    return {"emb": put(emb), "blocks": blocks,
            "ln_out_w": put(vec("ln_out.weight")), "ln_out_b": put(vec("ln_out.bias")),
            "head": put(get("head.weight").T)}


def load_model(path: str, dtype=torch.float32, vocab_size: Optional[int] = None,
               device=None):
    """A `.pth` checkpoint -> (config, tree on `device`)."""
    sd = load_state_dict_pth(path)
    config = infer_config(sd, vocab_size=vocab_size)
    return config, params_from_state_dict(sd, config, dtype=dtype, device=device)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree
    else:  # Mm8Weight / Mm8MultiWeight: its tensor fields
        for f in dataclasses.fields(tree):
            yield getattr(tree, f.name)


def parameter_groups(params):
    """Per-placement-unit size accounting: [{'name', 'size_mb', 'n_arrays'}]
    for the pre (embedding), per-layer and post (ln_out + head) groups; the
    layers are stacked, so a layer's size is the stacked leaves' over
    n_layer."""
    def leaf_bytes(tree):
        ts = list(_leaves(tree))
        return sum(t.numel() * t.element_size() for t in ts), len(ts)

    blocks = params["blocks"]
    L = blocks["ln1_w"].shape[0]
    pre_b, pre_n = leaf_bytes(params["emb"])
    blk_b, blk_n = leaf_bytes(blocks)
    post_b, post_n = leaf_bytes({k: params[k] for k in ("ln_out_w", "ln_out_b", "head")})
    groups = [{"name": "pre", "size_mb": pre_b / 2**20, "n_arrays": pre_n}]
    for i in range(L):
        groups.append({"name": f"layer_{i}", "size_mb": blk_b / L / 2**20,
                       "n_arrays": blk_n})
    groups.append({"name": "post", "size_mb": post_b / 2**20, "n_arrays": post_n})
    return groups


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


def _sharded_tree(dense, q8, config: RWKV7Config, int8_head: bool, shard: Tuple[int, int]):
    """_tree with every leaf made in _tree's order (so from the same draws of
    the generator) and cut to a tensor-parallel rank's shard at once
    (parallel/tp.shard_params): no more than one whole leaf at a time."""
    made = []

    def lazy(fn):
        def make(*args, **kwargs):
            made.append((fn, args, kwargs))
            return made[-1]
        return make

    tree = _tree(lazy(dense), lazy(q8), config, int8_head=int8_head)
    paths = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            paths[id(node)] = path

    walk(tree, ())
    values = {}
    for leaf in made:
        fn, args, kwargs = leaf
        values[id(leaf)] = shard_params(fn(*args, **kwargs), *shard, path=paths[id(leaf)])

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        return values[id(node)]

    return build(tree)


def synthetic_params_int8(config: RWKV7Config, seed: int = 0, dtype=torch.bfloat16,
                          device=None, shard: Optional[Tuple[int, int]] = None
                          ) -> Dict[str, Any]:
    """Parameter tree with Mm8Weight big matrices (random codes, constant
    scales) — the serving-dtype synthetic model: the same compute and memory
    behaviour as a real INT8 checkpoint, generated directly on `device` from a
    torch.Generator seeded with `seed` (a dense float 7.2B tree is never built).
    shard=(rank, tp): only that tensor-parallel rank's shard of the same tree,
    each leaf cut as it is made."""
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

    if shard is not None:
        return _sharded_tree(dense, q8, config, True, shard)
    return _tree(dense, q8, config, int8_head=True)


def _as_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes arrays: no numpy-native bf16
        return torch.from_numpy(a.astype(np.float32)).to(device=device,
                                                         dtype=torch.bfloat16)
    # a copy: the tree's arrays may be read-only views (of JAX arrays, say)
    return torch.from_numpy(np.array(a, order="C")).to(device)


def params_from_numpy(tree, device=None):
    """The JAX package's raw parameter tree (nested dicts of numpy arrays, as
    synthetic_params / synthetic_params_int8 / the checkpoint loader build it)
    -> this package's tree on `device`. An Mm8Weight may arrive as an object
    or as a dict with q, mx, rx, my, ry; dtypes are kept."""
    device = resolve_device(device)
    fields = mm8_fields(tree)
    if fields is not None:
        return Mm8Weight(**{f: _as_tensor(fields[f], device) for f in MM8_FIELDS})
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return _as_tensor(tree, device)
