"""Fixed-point core: Qn.m arithmetic and the sigmoid family, in PyTorch."""

from . import activations, fixedpoint
from .fixedpoint import FXP8, FXP16, FXP32, FxpFormat, FxpStats

__all__ = ["activations", "fixedpoint", "FxpFormat", "FxpStats", "FXP8",
           "FXP16", "FXP32"]
