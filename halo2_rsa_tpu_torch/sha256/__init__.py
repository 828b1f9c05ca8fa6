from .chip import Sha256Chip

__all__ = ["Sha256Chip"]
