"""Training substrate of the port: optimizers, LR schedules, checkpointing
and the fault-tolerant LM loop (:mod:`.checkpoint`, :mod:`.trainer`).

The counterpart of :mod:`repro.train`, with its exports; the classifier
trainers live beside their models in :mod:`repro_torch.models`.
"""

from .optim import adamw, sgd, clip_by_global_norm, OptState
from .schedule import cosine_schedule, warmup_linear

__all__ = ["adamw", "sgd", "clip_by_global_norm", "OptState",
           "cosine_schedule", "warmup_linear"]
