"""Device resolution for the PyTorch/CUDA port.

Counterpart of ``paddle_tpu/device/__init__.py``: there, devices come from
PjRt; here every entry point takes an explicit ``device``. The default is
the first CUDA card. ``"cpu"`` is used only when the caller asks for it
(the CPU tests do): with no card and no ``device="cpu"`` an entry point
raises instead of falling back to the CPU.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda``; ``"cpu"``/``"cuda[:i]"`` as given. Raises
    ``RuntimeError`` for CUDA when no card is visible, ``ValueError`` for
    any other device type."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on CUDA by default and no CUDA "
                "device is available; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
