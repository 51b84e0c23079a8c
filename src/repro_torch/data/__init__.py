from repro_torch.data.federated import partition
from repro_torch.data.synthetic import (Dataset, covtype_like, ijcnn1_like,
                                        logreg_dataset,
                                        logreg_full_loss_and_opt, logreg_loss,
                                        mnist_like, token_stream)

__all__ = ["Dataset", "covtype_like", "ijcnn1_like", "logreg_dataset",
           "logreg_full_loss_and_opt", "logreg_loss", "mnist_like",
           "partition", "token_stream"]
