from repro_torch.fed.orchestrator import FLOrchestrator, OrchestratorConfig  # noqa: F401
from repro_torch.fed.simulation import FLSimulation, SimConfig  # noqa: F401
