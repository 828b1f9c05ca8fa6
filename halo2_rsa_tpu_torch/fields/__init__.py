from .field import (
    ALL_FIELDS,
    BN254_FQ,
    BN254_FR,
    LIMB_BITS,
    LIMB_MASK,
    NUM_LIMBS,
    PASTA_FP,
    PASTA_FQ,
    REFERENCE_TEST_FIELDS,
    PrimeField,
)
from .limbs import (
    compose_big,
    decompose_big,
    field_limbs_to_int,
    int_to_field_limbs,
    ints_to_field_limbs,
)
from . import vecfield

__all__ = [
    "ALL_FIELDS",
    "BN254_FQ",
    "BN254_FR",
    "LIMB_BITS",
    "LIMB_MASK",
    "NUM_LIMBS",
    "PASTA_FP",
    "PASTA_FQ",
    "REFERENCE_TEST_FIELDS",
    "PrimeField",
    "compose_big",
    "decompose_big",
    "field_limbs_to_int",
    "int_to_field_limbs",
    "ints_to_field_limbs",
    "vecfield",
]
