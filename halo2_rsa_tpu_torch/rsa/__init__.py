from .chip import RSAChip
from .types import (
    DEFAULT_E,
    AssignedRSAPublicKey,
    AssignedRSASignature,
    RSAPubE,
    RSAPublicKey,
    RSASignature,
)

__all__ = [
    "DEFAULT_E",
    "AssignedRSAPublicKey",
    "AssignedRSASignature",
    "RSAChip",
    "RSAPubE",
    "RSAPublicKey",
    "RSASignature",
]
