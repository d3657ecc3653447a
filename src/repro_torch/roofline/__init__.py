from repro_torch.roofline.opcount import count_ops, OpCosts  # noqa: F401
from repro_torch.roofline.analysis import roofline_terms, RooflineReport, H100  # noqa: F401
