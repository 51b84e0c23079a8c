from repro_torch.optim.optimizers import (OPTIMIZER_NAMES, AdamState,
                                         Optimizer, adam, adamw,
                                         apply_updates, constant_schedule,
                                         cosine_schedule, get_optimizer,
                                         momentum, sgd)

__all__ = ["OPTIMIZER_NAMES", "AdamState", "Optimizer", "adam", "adamw",
           "apply_updates", "constant_schedule", "cosine_schedule",
           "get_optimizer", "momentum", "sgd"]
