"""Public type aliases."""

from __future__ import annotations

from typing import Callable

from .codegen.program import EinsumProgram

# A transform maps an einsum program to a (faster) einsum program.
TransformT = Callable[[EinsumProgram], EinsumProgram]
