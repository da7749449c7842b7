"""Registered lowerings, one module per model kind (importing this package
registers them)."""

from . import linear, mlp  # noqa: F401  (registration side effects)
