from repro_torch.core.robust_step import (FederatedState, RobustConfig,
                                          make_federated_step)

__all__ = ["FederatedState", "RobustConfig", "make_federated_step"]
