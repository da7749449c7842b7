"""Registered lowerings, one module per model kind (importing this package
registers them)."""

from . import linear, lm, mlp, svm, tree  # noqa: F401  (registration side effects)
