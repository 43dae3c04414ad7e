"""Server configuration: CLI flags + environment variables.

The JAX server's knobs (chirrup_tpu/server/config.py), argparse and
environment only. Env vars use the upper-cased flag name (MODEL_PATH, ...);
a flag overrides its env var, which overrides the profile, which overrides
the default.

`--profile <name>` applies a measured serving preset before the env/CLI
overrides.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import List, Optional


@dataclasses.dataclass
class ServerConfig:
    model_path: str = ""
    vocab_path: str = ""
    vocab_size: int = 65536
    head_size: int = 64
    worker_num: int = 1
    batch_size: int = 24
    state_cache_size: int = 50
    host: str = "127.0.0.1"
    port: int = 8000
    quantization: str = "int8"           # "int8" | "none"
    wkv_state_dtype: str = "bfloat16"    # float32 | bfloat16
    activation_dtype: str = "bfloat16"
    prefill_chunk: int = 64
    # decode-block steps per dispatch (0 = the worker's default for the
    # device: 16 on CUDA, 1 on the CPU); a bigger block spends less host time
    # a token and overshoots a stop token by more
    decode_block_size: int = 0
    # tensor parallelism and lockstep multi-host serving come with the port's
    # parallel slice; parse_config refuses anything but 1 and 0
    tensor_parallel: int = 1
    lockstep: int = 0
    # seconds the workers have to load the model, warm up and capture their
    # CUDA graphs before the server gives up
    load_timeout: float = 900.0
    # named preset of measured serving settings (see PROFILES below)
    profile: str = ""
    # test/dev hook: "L,C" builds a synthetic model of that size
    synthetic_model: str = ""
    # the torch device the workers run on ("" = the current CUDA device,
    # which must exist; "cpu" runs the plain PyTorch versions of the kernels)
    device: str = ""


# Measured serving presets. Values here are only applied where the user did
# not override the field via env var or CLI flag.
PROFILES = {
    # 7.2B (L32/C4096) INT8 on one NVIDIA H100 80GB HBM3 (700 W): the
    # configuration chip_smoke.py's server phase serves (w8a8, bf16
    # activations and WKV state, 16-step decode blocks, a 16-row state
    # pool). Measured by that phase on that card: healthy 16.3 s after the
    # spawn from a native checkpoint; a 1-token completion in 0.216 s; 64
    # streams of 128 tokens at 4,292.2 tok/s at the client, 0.616 of the
    # in-process steady decode; a 1,043-token conversation's first token at
    # 0.481 s, 0.323 s resumed with one more turn.
    "h100-7b2": {
        "batch_size": 64,
        "state_cache_size": 16,
        "decode_block_size": 16,
        "quantization": "int8",
        "wkv_state_dtype": "bfloat16",
        "activation_dtype": "bfloat16",
        "prefill_chunk": 64,
        "worker_num": 1,
    },
}


def parse_config(argv: Optional[List[str]] = None) -> ServerConfig:
    cfg = ServerConfig()
    parser = argparse.ArgumentParser(prog="chirrup_tpu_torch.server",
                                     description="RWKV-7 serving on PyTorch and CUDA")
    for f in dataclasses.fields(ServerConfig):
        # default=None so "explicitly provided" is detectable; layering below
        parser.add_argument(f"--{f.name}", f"--{f.name.replace('_', '-')}",
                            type=type(f.default), default=None)
    args = parser.parse_args(argv)

    profile = args.profile if args.profile is not None \
        else os.environ.get("PROFILE", "")
    if profile and profile not in PROFILES:
        parser.error(f"unknown --profile {profile!r}; "
                     f"available: {sorted(PROFILES)}")

    for f in dataclasses.fields(ServerConfig):
        value = f.default
        if profile and f.name in PROFILES[profile]:
            value = PROFILES[profile][f.name]
        env_val = os.environ.get(f.name.upper())
        if env_val is not None:
            value = type(f.default)(env_val)
        cli_val = getattr(args, f.name)
        if cli_val is not None:
            value = cli_val
        setattr(cfg, f.name, value)
    cfg.profile = profile
    if cfg.tensor_parallel != 1 or cfg.lockstep:
        parser.error("tensor_parallel > 1 and lockstep serving come with the port's "
                     "parallel slice (ROADMAP Queue 1 item 7); this server runs one "
                     "model on one device")
    return cfg
