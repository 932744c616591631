"""
Static per-device peak tables for roofline modeling, keyed by the sanitized
``torch.cuda.get_device_name()``.

All entries are NVIDIA data-sheet peaks (dense, no sparsity, at the card's
full power limit), not measurements.  The float32 entry is the CUDA-core FMA
peak, not the TF32 tensor-core peak: the port's kernels and its plain route
run IEEE fp32, because TF32 fails the 2e-5 float32 oracle.  A card set below
its full power limit runs slower under load; reports state the limit beside
every roofline share.
"""

from __future__ import annotations

import torch

from ..diagnostics import NoDevicePeaksInfoError

# peak GFLOP/s by dtype (data sheet)
DEV_TO_PEAK_GFLOPS = {
    "NVIDIA_H100_80GB_HBM3": {     # H100 SXM5, 700 W
        "float32": 67_000.0,
        "float64": 34_000.0,
    },
    "NVIDIA_H100_PCIe": {          # H100 PCIe, 350 W
        "float32": 51_000.0,
        "float64": 26_000.0,
    },
}

# peak device-memory bandwidth, GB/s (data sheet)
DEV_TO_PEAK_BW = {
    "NVIDIA_H100_80GB_HBM3": 3_350.0,
    "NVIDIA_H100_PCIe": 2_000.0,
}


def sanitize_device_name(name: str) -> str:
    """'NVIDIA H100 80GB HBM3' -> 'NVIDIA_H100_80GB_HBM3'."""
    return name.strip().replace(" ", "_").replace("-", "_")


def get_device_key(device=None) -> str:
    """Roofline-table and archive key for *device*:

    * ``None``: the current CUDA card (raises without one);
    * a ``torch.device`` or device string: ``"cuda"``/``"cuda:0"`` name the
      CUDA card's model, ``"cpu"`` is the key ``"cpu"`` (host timings, which
      no roofline table holds);
    * anything with a ``.name`` (:class:`~feinsum_tpu_torch.cl_utils.
      FakeDevice`): that name;
    * any other string: a device name or key."""
    if device is None:
        if not torch.cuda.is_available():
            raise NoDevicePeaksInfoError(
                "no CUDA card: name the device (a torch device, a device"
                " name or a FakeDevice)")
        device = torch.device("cuda", torch.cuda.current_device())
    if isinstance(device, str):
        try:
            device = torch.device(device)
        except RuntimeError:
            return sanitize_device_name(device)
    if not isinstance(device, torch.device):
        return sanitize_device_name(str(device.name))
    if device.type == "cpu":
        return "cpu"
    if device.type != "cuda":
        raise NoDevicePeaksInfoError(
            f"no device key for device type {device.type!r}")
    return sanitize_device_name(torch.cuda.get_device_name(device))
