"""RunSpec: the declarative description of one workload run.

A :class:`RunSpec` plus a :class:`~repro.api.precision.PrecisionPolicy` is
everything :class:`~repro.api.session.Session` needs to stand up any of the
five workload kinds — there is no other configuration channel.  Specs
round-trip through plain dicts (``to_dict``/``from_dict``) so launchers,
sweep drivers, and checkpoints can persist them as JSON.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.api.precision import PrecisionPolicy

#: The workload kinds Session can launch.
WORKLOADS = ("train", "serve", "dryrun", "fl-sim", "fl-orchestrate")

#: Architectures the fl-sim (paper CIFAR-class) workload accepts; every other
#: workload takes a model-zoo registry name (repro.configs.ARCH_NAMES).
SIM_ARCHS = ("mobilenet", "resnet")


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """What to run: arch + workload + mesh topology + seed + precision.

    ``mesh`` is ``"DATAxMODEL"`` (e.g. ``"1x1"``, ``"16x16"``) or
    ``"PODxDATAxMODEL"`` (e.g. ``"2x16x16"``).  ``batch`` is the per-client
    batch for training workloads and the number of decode slots for serving.
    ``seq`` is the training sequence length / serving ``s_max``.
    Workload-specific knobs (steps, prompt_len, scheme, lr, ...) live in
    ``options`` — see :class:`~repro.api.session.Session` for the per-workload
    keys it reads.
    """

    arch: str
    workload: str = "train"
    mesh: str = "1x1"
    smoke: bool = True
    seed: int = 0
    batch: int = 4
    seq: int = 32
    rounds: int = 10
    precision: PrecisionPolicy = dataclasses.field(
        default_factory=PrecisionPolicy)
    options: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.workload not in WORKLOADS:
            raise ValueError(f"workload must be one of {WORKLOADS}, "
                             f"got {self.workload!r}")
        if isinstance(self.precision, dict):
            object.__setattr__(self, "precision",
                               PrecisionPolicy.from_dict(self.precision))

    def opt(self, key: str, default: Any = None) -> Any:
        return self.options.get(key, default)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["precision"] = self.precision.to_dict()
        d["options"] = dict(self.options)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "RunSpec":
        d = dict(d)
        if "precision" in d:
            d["precision"] = PrecisionPolicy.from_dict(d["precision"])
        return cls(**d)
