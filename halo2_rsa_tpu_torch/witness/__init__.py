from .replay import WitnessProgram

__all__ = ["WitnessProgram"]
