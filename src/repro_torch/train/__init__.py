"""Training substrate of the port: optimizers, LR schedules and the
checkpoint codec.

The counterpart of :mod:`repro.train`, with its exports except the LM
trainer (``train/trainer.py``), which arrives with the LM half of the
trainers' slice; the classifier trainers live beside their models in
:mod:`repro_torch.models`.
"""

from .optim import adamw, sgd, clip_by_global_norm, OptState
from .schedule import cosine_schedule, warmup_linear

__all__ = ["adamw", "sgd", "clip_by_global_norm", "OptState",
           "cosine_schedule", "warmup_linear"]
