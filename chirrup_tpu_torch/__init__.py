"""chirrup_tpu_torch — RWKV-7 serving in PyTorch with hand-written CUDA kernels
for NVIDIA Hopper (sm_90a).

The PyTorch port of ``chirrup_tpu``. It imports neither JAX nor anything of
``chirrup_tpu``. Its entry points run on the CUDA device unless the caller asks
for the CPU (``device="cpu"``), where every kernel is replaced by its plain
PyTorch version; a CUDA tensor always gets the kernel, or an error.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: the current CUDA device unless one is
    given. Raises when none is given and CUDA is absent — the port does not
    quietly fall back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("chirrup_tpu_torch: no CUDA device available; pass "
                               "device='cpu' to run the plain PyTorch versions")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
