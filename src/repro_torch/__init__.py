"""PyTorch/CUDA port of the ``repro`` package.

Module paths and names follow ``repro``, so each file here has one
counterpart there. The port imports ``torch`` and never ``jax`` or ``repro``.
Entry points run on the CUDA device unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

Device = Union[str, torch.device, None]


def resolve_device(device: Device = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless one is named.

    Raises when CUDA is asked for (or defaulted to) and no card is present;
    an entry point never carries on on the CPU unless told to.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev

