from .comm import COLLECTIVE_KINDS, CollectiveOp, collective_bytes, record
from .roofline import HW, RooflineTerms, model_flops, roofline_from_artifacts

__all__ = ["COLLECTIVE_KINDS", "CollectiveOp", "collective_bytes", "record",
           "HW", "RooflineTerms", "model_flops", "roofline_from_artifacts"]
