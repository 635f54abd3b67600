"""Device and dtype resolution. The port never picks a device on its own:
the caller names it, and asking for CUDA where there is none raises."""

from __future__ import annotations

import torch

_DTYPES = {
    "float32": torch.float32,
    "fp32": torch.float32,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "float16": torch.float16,
    "fp16": torch.float16,
}


def resolve_dtype(name) -> torch.dtype:
    """``config.ModelArguments.dtype`` names -> torch dtypes."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; one of "
                         f"{sorted(_DTYPES)}") from None


def resolve_device(name) -> torch.device:
    """``"cuda"``, ``"cuda:1"`` or ``"cpu"`` -> a torch.device. A CUDA
    device that is not present raises; the CPU is used only when named."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {name!r} requested but CUDA is not "
                               "available")
        index = device.index if device.index is not None else 0
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"device {name!r} requested but only "
                               f"{torch.cuda.device_count()} CUDA devices "
                               "are present")
        return torch.device("cuda", index)
    if device.type != "cpu":
        raise ValueError(f"unsupported device {name!r} (cuda | cpu)")
    return device
