from .field import BN254_FQ, BN254_FR, PrimeField

__all__ = ["BN254_FQ", "BN254_FR", "PrimeField"]
