"""The port's roofline: step costs from a trace, priced on one H100."""

from repro_torch.roofline.analysis import RooflineReport, analyze_trace, model_flops  # noqa: F401
from repro_torch.roofline.hw import H100_SXM, ChipSpec  # noqa: F401
