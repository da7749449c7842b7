"""Hand-written CUDA kernels for Hopper, with their plain PyTorch versions.

Each kernel module holds the launcher of a CUDA C++ kernel (``csrc/``,
built by :mod:`.build` with ``nvcc`` at first use and bound with ``ctypes``)
and the plain PyTorch version of the same function; :mod:`.ops` routes
between them by device and :mod:`.ref` holds the int64 oracles.

* fxp_layer      — fused Qn.m layer: int32 matmul + requantize + bias +
                   sigmoid epilogue (replaces ``fxp_layer_pallas``)
* fxp_qmatmul    — Qn.m matmul with round-shift-saturate, the kernel
                   SVM's per-layer first stage (replaces
                   ``fxp_qmatmul_pallas``)
* fxp_model      — whole-MLP and whole-kernel-SVM megakernels, one launch
                   per forward pass (replace ``fxp_mlp_model_pallas`` and
                   ``fxp_svm_model_pallas``)
* tree_ensemble  — decision-tree inference, one warp per row (replaces
                   ``tree_ensemble_pallas``)
"""
