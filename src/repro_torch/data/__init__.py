from repro_torch.data.partition import dirichlet_partition  # noqa: F401
from repro_torch.data.synthetic import SyntheticImages, SyntheticTokens  # noqa: F401
from repro_torch.data.pipeline import ClientBatcher, TokenBatcher  # noqa: F401
