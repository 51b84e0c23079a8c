from repro_torch.optim.optimizers import (Optimizer, apply_updates,
                                         constant_schedule, get_optimizer, sgd)

__all__ = ["Optimizer", "apply_updates", "constant_schedule",
           "get_optimizer", "sgd"]
