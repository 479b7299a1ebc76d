"""The roofline of a step on the H100: the analytic cost model
(``model``) and the collective counter of a traced program (``hlo``)."""
from .model import HBM_BW, LINK_BW, PEAK_FLOPS, roofline_terms, step_cost

__all__ = ["HBM_BW", "LINK_BW", "PEAK_FLOPS", "roofline_terms", "step_cost"]
