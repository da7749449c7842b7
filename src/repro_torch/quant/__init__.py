"""repro_torch.quant — calibration-driven per-tensor Qn.m planning.

Numpy-only, as in :mod:`repro.quant`: a lowering replays its program in
float over a sample batch (:mod:`.calibrate`), and the planner
(:mod:`.plan`) freezes a :class:`QuantPlan` giving every tensor path the
maximal fractional bits that cannot saturate.  Selected through
``Target(number_format="auto16" | "auto8" | "auto32")``.
"""

from .calibrate import activation_range, amax, make_plan
from .plan import Calibration, QuantPlan, choose_frac_bits, plan_formats

__all__ = ["QuantPlan", "Calibration", "plan_formats", "choose_frac_bits",
           "make_plan", "amax", "activation_range"]
