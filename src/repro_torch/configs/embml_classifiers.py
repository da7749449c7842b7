"""The paper's own model zoo as a config (EmbML classifier suite).

Not an LM architecture: selects the classical pipeline (train -> convert ->
embedded artifact) over the six benchmark datasets.  The port's own copy of
:mod:`repro.configs.embml_classifiers` (pure Python; the port imports
nothing of the reference package).
"""

import dataclasses
from typing import Tuple

__all__ = ["EmbMLSuiteConfig", "SUITE"]


@dataclasses.dataclass(frozen=True)
class EmbMLSuiteConfig:
    datasets: Tuple[str, ...] = ("D1", "D2", "D3", "D4", "D5", "D6")
    classifiers: Tuple[str, ...] = (
        "tree", "logistic", "mlp", "svm-linear", "svm-poly", "svm-rbf")
    number_formats: Tuple[str, ...] = ("flt", "fxp32", "fxp16")
    sigmoids: Tuple[str, ...] = ("exact", "rational", "pwl2", "pwl4")
    tree_layouts: Tuple[str, ...] = ("iterative", "ifelse", "oblivious")


SUITE = EmbMLSuiteConfig()
