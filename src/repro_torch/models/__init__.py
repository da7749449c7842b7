"""Classical classifier zoo (paper §III-B) + trainers, on PyTorch.

The counterpart of :mod:`repro.models`, with its ``__all__``: J48/CART
decision trees (numpy), multinomial logistic regression, an MLP with
sigmoid hidden units, and SVMs with linear / polynomial / RBF kernels.  The
Adam trainers run on the current CUDA device unless given ``device="cpu"``;
the models they return hold numpy arrays, and inference goes through
:func:`repro_torch.compile.compile`.
"""

from .blobs import synthetic_blobs
from .decision_tree import DecisionTreeModel, train_decision_tree
from .logistic import LogisticModel, train_logistic
from .mlp import MLPModel, init_mlp, train_mlp
from .svm import SVMModel, train_linear_svm, train_kernel_svm

__all__ = [
    "DecisionTreeModel",
    "train_decision_tree",
    "LogisticModel",
    "train_logistic",
    "MLPModel",
    "train_mlp",
    "SVMModel",
    "train_linear_svm",
    "train_kernel_svm",
    "synthetic_blobs",
    "init_mlp",
]
