from repro_torch.optim.optimizers import Optimizer, adamw, build_optimizer, sgd  # noqa: F401
from repro_torch.optim.schedules import constant, cosine_decay, warmup_cosine  # noqa: F401
