from .chip import BigIntChip
from .types import FRESH, MULED, AssignedInteger, RefreshAux
from .utils import big_pow_mod

__all__ = [
    "AssignedInteger",
    "BigIntChip",
    "FRESH",
    "MULED",
    "RefreshAux",
    "big_pow_mod",
]
