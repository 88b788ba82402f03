"""Optimizers and learning-rate schedules. Reference: ``src/repro/optim/``."""
from repro_torch.optim.optimizers import (Optimizer, adagrad, adam,  # noqa: F401
                                          clip_by_global_norm, global_norm,
                                          make_optimizer, momentum,
                                          rmsprop_momentum, sgd)
from repro_torch.optim import schedules  # noqa: F401
