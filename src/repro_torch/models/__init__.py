"""Classifier containers (paper §III-B) and the CART trainer; the Adam
trainers arrive with their slice."""

from .decision_tree import DecisionTreeModel, train_decision_tree
from .logistic import LogisticModel
from .mlp import MLPModel, init_mlp
from .svm import SVMModel

__all__ = ["DecisionTreeModel", "train_decision_tree", "LogisticModel",
           "MLPModel", "init_mlp", "SVMModel"]
