"""The device the port's entry points run on."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The caller's device, or the CUDA card when none is given.

    Entry points (`Trainer`, `InferenceServer`) run on the card unless the
    caller asks for another device, e.g. `device="cpu"`. Without a card
    the default raises: nothing falls back to the CPU.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible: pass device='cpu' to "
                           "run on the CPU")
    return torch.device("cuda")
