"""Roofline of the port: the analytic cost model of a step (the HLO
analysis of the reference's dry run waits for the multi-GPU slice)."""

from .analytic import CostBreakdown, analytic_cost

__all__ = ["analytic_cost", "CostBreakdown"]
