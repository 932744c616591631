"""Workload models built on the einsum framework: the DG wave and Maxwell
operators of ``feinsum_tpu.models`` as ``torch.nn.Module``\\ s."""

from .maxwell import MaxwellOperator3D, make_maxwell_state
from .wave import WaveOperator3D, make_wave_state, state_from_reference

__all__ = ("MaxwellOperator3D", "WaveOperator3D", "make_maxwell_state",
           "make_wave_state", "state_from_reference")
