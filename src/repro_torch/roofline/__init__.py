"""Roofline of the port: the analytic cost model of a step, and the roofline
terms of the dry run's plans (with the reference's HLO text parser)."""

from .analysis import (HW, RooflineReport, collective_bytes_from_hlo,
                       model_flops, roofline_terms)
from .analytic import CostBreakdown, analytic_cost

__all__ = ["analytic_cost", "CostBreakdown", "HW",
           "collective_bytes_from_hlo", "roofline_terms", "model_flops",
           "RooflineReport"]
