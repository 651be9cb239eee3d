"""Where the port runs: the card by default, the CPU only when asked."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """The device an entry point runs on.

    None means "cuda".  A CUDA device that is not there raises — the port
    never falls back to the CPU quietly; pass device="cpu" for that.  A
    CUDA device without an index gets the current one, so "cuda" and
    "cuda:0" name one device and compare equal.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
