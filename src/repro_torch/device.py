"""The port's device rule, shared by the decoder engine and the LM path.

Entry points run on the card unless the caller asks for the CPU:
``device=None`` means ``"cuda"``, and a CUDA device that torch cannot find
raises :class:`DeviceUnavailableError` instead of carrying on on the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["DeviceUnavailableError", "resolve_device", "dispatch_type"]

#: the device type a meta tensor stands for while a work counter counts
#: (``launch/cost.py``), else ``None``
_META_STANDS_FOR: list = [None]


class DeviceUnavailableError(RuntimeError):
    """An entry point was asked for a CUDA device and the host has none."""


def resolve_device(device: str | torch.device | None, user: str = "DecoderEngine") -> torch.device:
    """``None`` → ``"cuda"``; a CUDA device must exist. ``user`` names the
    entry point in the error."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailableError(
            f"{user} wants device {str(dev)!r} but torch finds no CUDA "
            f"device; pass device='cpu' to run on the CPU with the kernels' "
            f"plain PyTorch versions"
        )
    return dev


def dispatch_type(t: torch.Tensor) -> str:
    """The device type a dispatch decision reads for ``t``: its own, except
    that inside a work counter (``launch/cost.py``) a meta tensor stands for
    the counter's target device, so that the count takes the card's
    branches."""
    kind = t.device.type
    if kind == "meta" and _META_STANDS_FOR[0] is not None:
        return _META_STANDS_FOR[0]
    return kind
