from . import curve, g1_vec, msm

__all__ = ["curve", "g1_vec", "msm"]
