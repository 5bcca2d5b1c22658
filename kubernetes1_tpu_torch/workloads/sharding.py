"""Device placement for the workloads.

The JAX package's ``sharding.auto_mesh`` picks the mesh over every
visible chip.  This slice runs on one card, so its counterpart only
chooses the device: the card, unless the caller names another.  The
``DeviceMesh`` counterpart comes with the sharded training step.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device a workload runs on: ``cuda`` when none is named.

    Raises when the named (or default) device is a CUDA device and no
    card is visible: nothing falls back to the CPU silently; a caller
    that wants the CPU passes ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run on the CPU")
    return dev
