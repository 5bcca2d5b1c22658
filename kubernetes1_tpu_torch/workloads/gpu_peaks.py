"""GPU peak-FLOPs table, the counterpart of the JAX package's
``tpu_peaks.py``.

One ``torch.device`` of kind "cuda" is one whole GPU, so the granularity
is always "gpu".  Peaks are dense bf16 tensor-core rates per GPU (without
sparsity) from NVIDIA's H100 data sheet, at each part's full power limit.
"""

from __future__ import annotations

import torch

# dense bf16 FLOP/s per GPU, by torch.cuda.get_device_name
PEAK_FLOPS_PER_GPU = {
    "NVIDIA H100 80GB HBM3": 989e12,  # H100 SXM
    "NVIDIA H100 NVL": 835e12,
    "NVIDIA H100 PCIe": 756e12,
}


def peak_flops_per_device(device) -> tuple:
    """(peak bf16 FLOP/s of ONE device, granularity label).

    Unknown kinds (the CPU in tests, other cards) return (0.0, "device"),
    as in the JAX package; a name that extends a known one ("NVIDIA H100
    80GB HBM3 ...") matches it, longest first."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return 0.0, "device"
    kind = torch.cuda.get_device_name(device)
    for known in sorted(PEAK_FLOPS_PER_GPU, key=len, reverse=True):
        if kind.startswith(known):
            return PEAK_FLOPS_PER_GPU[known], "gpu"
    return 0.0, "device"
