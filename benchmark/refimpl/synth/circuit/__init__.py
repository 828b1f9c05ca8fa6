from .builder import Builder, Cell
from .main_gate import MainGate
from .range_chip import NUM_LOOKUP_LIMBS, RangeChip, sublimb_bit_len

__all__ = ["Builder", "Cell", "MainGate", "NUM_LOOKUP_LIMBS", "RangeChip", "sublimb_bit_len"]
