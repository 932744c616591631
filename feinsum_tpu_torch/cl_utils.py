"""
Device stand-ins for archive queries: anything with a ``.name`` names a
device, so the archive can be read for a device that is not present, e.g.
``FakeDevice("TPU_v5_lite")`` or ``FakeDevice("NVIDIA H100 80GB HBM3")``
(the names of ``feinsum_tpu.cl_utils``).
"""

from __future__ import annotations

from dataclasses import dataclass


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
