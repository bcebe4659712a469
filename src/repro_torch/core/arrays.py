"""Array-contract annotation aliases for flat-array signatures.

The port's copy of ``repro.core.arrays``. A flat host array in a signature
is annotated as ``Annotated[F8, "F"]``: the alias carries the dtype (``F8``
= float64, ``I8`` = int64, ``B1`` = bool, ``F4``/``I4`` the 32-bit
variants) and the string the shape, one space-separated name per dimension
(``F`` flows, ``M`` coflows, ``N`` ports, ``K`` cores, ``G`` admitted
coflows, ``B`` an arrival batch, ``S`` program segments, ``E`` events,
``R`` resources). ``"*"`` is a dimension whose extent is unchecked. The
annotations cost nothing at run time (``from __future__ import
annotations``).
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Annotated, TypeAlias

import numpy as np
import numpy.typing as npt

__all__ = ["F8", "F4", "I8", "I4", "B1", "Arr", "Annotated"]

if TYPE_CHECKING:
    F8: TypeAlias = npt.NDArray[np.float64]
    F4: TypeAlias = npt.NDArray[np.float32]
    I8: TypeAlias = npt.NDArray[np.int64]
    I4: TypeAlias = npt.NDArray[np.int32]
    B1: TypeAlias = npt.NDArray[np.bool_]
    #: Any-dtype escape hatch for arrays whose dtype is data-dependent.
    Arr: TypeAlias = npt.NDArray[np.generic]
else:  # runtime aliases (cheap; never subscripted)
    F8 = npt.NDArray[np.float64]
    F4 = npt.NDArray[np.float32]
    I8 = npt.NDArray[np.int64]
    I4 = npt.NDArray[np.int32]
    B1 = npt.NDArray[np.bool_]
    Arr = npt.NDArray[np.generic]
