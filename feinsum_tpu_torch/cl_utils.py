"""
Device stand-ins for archive queries: anything with a ``.name`` names a
device, so the archive can be read for a device that is not present, e.g.
``FakeDevice("TPU_v5_lite")`` or ``FakeDevice("NVIDIA H100 80GB HBM3")``
(the names of ``feinsum_tpu.cl_utils``).  :func:`default_device` resolves
the device an entry point runs on when its caller names none.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


def default_device(device=None, *, caller: str) -> torch.device:
    """*device* as a ``torch.device``, or the current CUDA card when it is
    ``None``.  Raises ``RuntimeError`` when there is no card: the CPU is
    used only when the caller names it (``device="cpu"``)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(f"{caller}: no CUDA card; pass device='cpu' to"
                           " work on the host")
    return torch.device("cuda", torch.cuda.current_device())


@dataclass(frozen=True)
class FakeDevice:
    """A device known only by its name; it keys archive queries and runs
    nothing."""

    name: str

    @property
    def device_kind(self) -> str:
        return self.name


# the reference's name for the same stand-in
FakeCLDevice = FakeDevice
