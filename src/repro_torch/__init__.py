"""repro_torch — the EmbML classifier compiler on PyTorch and CUDA.

The PyTorch port of :mod:`repro`, module for module: a trained classifier is
compiled into a fixed-point artifact (``repro_torch.compile.compile``) whose
predict runs on an NVIDIA Hopper card through hand-written CUDA kernels
(``repro_torch.kernels``), or on the host through their plain PyTorch
versions when the caller asks for ``device="cpu"``.  The dense LM stack
(``repro_torch.lm``) serves through the same compiler, its prefill
attention through the ``flash_attention`` kernel.  The JAX package stays
the reference; the port imports neither JAX nor anything of ``repro``.
"""

__version__ = "1.0.0"
