from repro_torch.data import federated, synthetic

__all__ = ["federated", "synthetic"]
