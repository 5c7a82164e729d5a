"""Tree checkpointing in the reference's file format (``checkpoint.io``)."""
from repro_torch.checkpoint.io import restore, save

__all__ = ["save", "restore"]
