"""Plain PyTorch forwards that ``correct`` is judged against, one module a
model family.  They import nothing of the port: they read the weights and
inputs that the benchmark drew (the parameter tree as the port's
``forward`` takes it) and recompute the logits from them in float32 with
TF32 off, or, for the control, with every product's operands rounded to
float8 (``precision="fp8"``)."""
