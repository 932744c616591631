"""Workload models built on the einsum framework: the DG wave and Maxwell
operators of ``feinsum_tpu.models`` as ``torch.nn.Module``\\ s, the
spectral-element wave operator on hexahedra (``hexwave``) and SeisSol's
elastic and viscoelastic ADER-DG elements (``ader``, ``ader_visco``)."""

from .ader import AderElasticOperator3D, make_ader_state
from .ader_visco import AderViscoelasticOperator3D, make_ader_visco_state
from .hexwave import HexWaveOperator3D, make_hexwave_state
from .maxwell import MaxwellOperator3D, make_maxwell_state
from .wave import WaveOperator3D, make_wave_state, state_from_reference

__all__ = ("AderElasticOperator3D", "AderViscoelasticOperator3D",
           "HexWaveOperator3D",
           "MaxwellOperator3D", "WaveOperator3D", "make_ader_state",
           "make_ader_visco_state",
           "make_hexwave_state", "make_maxwell_state", "make_wave_state",
           "state_from_reference")
