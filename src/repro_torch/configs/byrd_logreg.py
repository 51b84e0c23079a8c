"""The paper's own workload: l2-regularized logistic regression (Sec. V-A).

Not one of the assigned LLM architectures — this config drives the exact
reproduction benchmarks (Figs. 3-6, Table I) at the paper's scale:
W-B = 50 honest workers + B = 20 Byzantine, IJCNN1/COVTYPE-like data.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class LogRegConfig:
    dataset: str = "ijcnn1"   # ijcnn1 | covtype
    num_honest: int = 50
    num_byzantine: int = 20
    rho: float = 0.01
    steps: int = 3000
    lr_sgd: float = 0.02
    lr_bsgd: float = 0.01
    lr_saga: float = 0.02
    minibatch: int = 50
    geomed_eps: float = 1e-5


CONFIG = LogRegConfig()
