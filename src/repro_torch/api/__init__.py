"""Public API of the port: RunSpec + PrecisionPolicy -> Session."""

from repro_torch.api.precision import PrecisionPolicy
from repro_torch.api.program import PrecisionProgram, build_program
from repro_torch.api.session import ServeStats, Session
from repro_torch.api.spec import RunSpec

__all__ = ["PrecisionPolicy", "PrecisionProgram", "RunSpec", "ServeStats",
           "Session", "build_program"]
