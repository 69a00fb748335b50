"""Where the port's entry points run: on the card unless the caller names
another device.  A missing card is an error, never a silent CPU run."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device without a card raises.  A
    bare ``"cuda"`` becomes the current card's indexed device, so devices
    compare equal to the ones tensors report."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
