"""Classifier containers (paper §III-B); trainers arrive with their slice."""

from .logistic import LogisticModel
from .mlp import MLPModel, init_mlp

__all__ = ["LogisticModel", "MLPModel", "init_mlp"]
