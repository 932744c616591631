"""Exception taxonomy (the same classes as ``feinsum_tpu.diagnostics``)."""

from __future__ import annotations


class FeinsumTPUError(Exception):
    """Base class for all feinsum_tpu_torch errors."""


class EinsumMatchError(FeinsumTPUError):
    """Raised when a user program cannot be matched against the batched-einsum
    grammar (analog of the reference's ``EinsumTunitMatchError``)."""


# Reference-compatible alias
EinsumTunitMatchError = EinsumMatchError


class InvalidParameterError(FeinsumTPUError):
    """Raised when a program or tuning point is well formed but illegal for
    the target hardware, or names a route this package does not implement."""


class NoDevicePeaksInfoError(FeinsumTPUError):
    """Raised when the roofline tables have no entry for a device."""


class TransformValidationError(FeinsumTPUError):
    """Raised when a transformed kernel's output mismatches the reference
    einsum evaluation."""


class NoFactInDatabaseError(FeinsumTPUError):
    """Raised when the transform archive contains no fact for a query."""
