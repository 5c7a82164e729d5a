from repro_torch.data import federated, synthetic
from repro_torch.data.federated import (FederatedSplits, client_epoch_batches,
                                        epoch_batches, split_federated)
from repro_torch.data.synthetic import (CIFAR_LIKE, VOC_LIKE, XRAY_LIKE,
                                        ImageTask, make_image_dataset,
                                        make_markov_lm)

__all__ = [
    "federated", "synthetic",
    "FederatedSplits", "split_federated", "epoch_batches",
    "client_epoch_batches",
    "ImageTask", "CIFAR_LIKE", "VOC_LIKE", "XRAY_LIKE",
    "make_image_dataset", "make_markov_lm",
]
