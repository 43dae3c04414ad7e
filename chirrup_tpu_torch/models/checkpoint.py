"""Native checkpoint format: a directory of .npy files + meta.json.

The same on-disk format as the JAX package's native checkpoints, so a
directory either package writes loads in the other: the fully prepared
parameter tree (transposed, ln0 folded, optionally INT8-quantized), one .npy
file a leaf, an Mm8Weight as five leaves `<path>.__mm8_{q,mx,rx,my,ry}`.

Layout:
  <dir>/meta.json              format_version, config, leaf manifest
                               ({path: {file, dtype, shape}})
  <dir>/<flattened.path>.npy   one array per tree leaf

numpy has no bfloat16: a bfloat16 leaf is stored as 2-byte void elements
(descr '<V2', as numpy writes an ml_dtypes bfloat16 array) and read by the
manifest's dtype string as uint16 bits viewed as torch.bfloat16.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Dict, Tuple

import numpy as np
import torch

from chirrup_tpu_torch import resolve_device
from chirrup_tpu_torch.models.config import RWKV7Config
from chirrup_tpu_torch.ops.mm8 import Mm8Weight

FORMAT_VERSION = 1
_MM8_FIELDS = ("q", "mx", "rx", "my", "ry")

# manifest dtype string -> (torch dtype, .npy descr)
_DTYPES = {
    "float32": (torch.float32, "<f4"),
    "float16": (torch.float16, "<f2"),
    "bfloat16": (torch.bfloat16, "<V2"),
    "int8": (torch.int8, "|i1"),
    "int32": (torch.int32, "<i4"),
}
_NAMES = {t: name for name, (t, _) in _DTYPES.items()}

# host bytes staged per copy to a CUDA device (pinned, reused for every leaf)
STAGING_BYTES = 64 << 20


def _flatten(params) -> Dict[str, torch.Tensor]:
    """{dotted.path: tensor}, an Mm8Weight expanded into its five leaves."""
    flat = {}

    def walk(prefix, node):
        if isinstance(node, Mm8Weight):
            for f in _MM8_FIELDS:
                flat[f"{prefix}.__mm8_{f}"] = getattr(node, f)
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}.{k}" if prefix else k, v)
        else:
            flat[prefix] = node

    walk("", params)
    return flat


def _unflatten(flat: Dict[str, torch.Tensor]):
    """The tree of _flatten's leaves, keys in the manifest's order (so a
    tree loaded and saved again writes the same meta.json)."""
    tree: Dict[str, Any] = {}
    mm8_groups = []

    for path, t in flat.items():
        m = re.match(r"^(.*)\.__mm8_([a-z]+)$", path)
        parts = (m.group(1) if m else path).split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        if m:
            if parts[-1] not in node:
                mm8_groups.append((node, parts[-1]))
            node.setdefault(parts[-1], {})[m.group(2)] = t
        else:
            node[parts[-1]] = t
    for node, key in mm8_groups:
        node[key] = Mm8Weight(**node[key])
    return tree


def _write_leaf(fname: str, t: torch.Tensor) -> str:
    """Write one leaf as a .npy file, byte for byte what np.save writes for
    the same array (the JAX package's writer); returns its dtype string."""
    if t.dtype not in _NAMES:
        raise ValueError(f"native checkpoint: unsupported leaf dtype {t.dtype}")
    name = _NAMES[t.dtype]
    host = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        header = {"descr": _DTYPES[name][1], "fortran_order": False,
                  "shape": tuple(host.shape)}
        with open(fname, "wb") as f:
            np.lib.format.write_array_header_1_0(f, header)
            f.write(host.view(torch.int16).numpy().tobytes())
    else:
        np.save(fname, host.numpy())
    return name


def save_native(path: str, config: RWKV7Config, params) -> None:
    """Write `params` (this package's tree, on any device) as a native
    checkpoint directory, one leaf at a time."""
    os.makedirs(path, exist_ok=True)
    manifest = {}
    for key, leaf in _flatten(params).items():
        fname = key.replace("/", "_") + ".npy"
        dtype = _write_leaf(os.path.join(path, fname), leaf)
        manifest[key] = {"file": fname, "dtype": dtype, "shape": list(leaf.shape)}
    meta = {
        "format_version": FORMAT_VERSION,
        "config": dataclasses.asdict(config),
        "leaves": manifest,
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)


def _read_header(f, fname: str):
    version = np.lib.format.read_magic(f)
    if version == (1, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
    elif version == (2, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
    else:
        raise ValueError(f"{fname}: unsupported .npy version {version}")
    if fortran:
        raise ValueError(f"{fname}: Fortran-ordered arrays are not supported")
    return tuple(shape), dtype


def _read_leaf(fname: str, info: Dict[str, Any], device: torch.device,
               staging: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One leaf into a new tensor on `device`. The file is read straight into
    the tensor on the CPU, and through one reused pinned buffer of
    STAGING_BYTES to a CUDA device, so the host holds at most that buffer
    beside the page cache, never a leaf's copy."""
    if info["dtype"] not in _DTYPES:
        raise ValueError(f"{fname}: unsupported leaf dtype {info['dtype']!r}")
    dtype = _DTYPES[info["dtype"]][0]
    with open(fname, "rb") as f:
        shape, file_dtype = _read_header(f, fname)
        if list(shape) != list(info["shape"]):
            raise ValueError(f"{fname}: shape {shape} != manifest {info['shape']}")
        out = torch.empty(shape, dtype=dtype, device=device)
        if file_dtype.itemsize != out.element_size():
            raise ValueError(f"{fname}: {file_dtype} does not hold {info['dtype']}")
        dest = out.view(-1).view(torch.uint8)
        n = dest.numel()
        if device.type != "cuda":
            if f.readinto(dest.numpy()) != n:
                raise ValueError(f"{fname}: file shorter than its header says")
            return out
        if "buf" not in staging:
            staging["buf"] = torch.empty(STAGING_BYTES, dtype=torch.uint8, pin_memory=True)
        buf = staging["buf"]
        view = buf.numpy()
        for off in range(0, n, STAGING_BYTES):
            m = min(STAGING_BYTES, n - off)
            if f.readinto(view[:m]) != m:
                raise ValueError(f"{fname}: file shorter than its header says")
            dest[off:off + m].copy_(buf[:m])  # synchronous: buf is reused next
    return out


def _meta(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta["format_version"] != FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint format {meta['format_version']}")
    return meta


def native_config(path: str) -> RWKV7Config:
    """The model configuration of a native checkpoint (meta.json only)."""
    return RWKV7Config(**_meta(path)["config"])


def load_native(path: str, device=None) -> Tuple[RWKV7Config, Any]:
    """(config, tree) of a native checkpoint directory, each leaf copied
    once from its file to `device` (the CUDA device unless one is given)."""
    device = resolve_device(device)
    meta = _meta(path)
    config = RWKV7Config(**meta["config"])
    staging: Dict[str, torch.Tensor] = {}
    flat = {key: _read_leaf(os.path.join(path, info["file"]), info, device, staging)
            for key, info in meta["leaves"].items()}
    return config, _unflatten(flat)


def is_native_checkpoint(path: str) -> bool:
    return os.path.isdir(path) and os.path.exists(os.path.join(path, "meta.json"))
