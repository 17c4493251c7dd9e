"""Device selection for the port's entry points.

They run on the card unless the caller asks for the CPU. A ``cuda``
request on a host without a CUDA device, or with one older than Hopper,
raises; it never carries on on the CPU.
"""

from __future__ import annotations

import torch

PLATFORMS = ("cuda", "cpu")


def resolve_device(platform: str = "cuda", index: int = 0) -> torch.device:
    """``cuda`` → CUDA device ``index`` (capability ≥ 9.0), ``cpu`` → the
    host. Raises RuntimeError when a card is asked for and cannot serve."""
    if platform == "cpu":
        return torch.device("cpu")
    if platform != "cuda":
        raise ValueError(f"unknown platform {platform!r} (choose from {PLATFORMS})")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "platform 'cuda' requested but torch sees no CUDA device; pass "
            "--platform cpu (device='cpu') to run on the host"
        )
    capability = torch.cuda.get_device_capability(index)
    if capability < (9, 0):
        raise RuntimeError(
            f"platform 'cuda' needs a Hopper card (capability >= 9.0) for "
            f"the flash kernels; {torch.cuda.get_device_name(index)} is "
            f"{capability[0]}.{capability[1]}"
        )
    return torch.device("cuda", index)
