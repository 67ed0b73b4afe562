"""Data pipelines of the port (counterpart of `repro.data`)."""
from repro_torch.data.tokens import SyntheticTokenDataset

__all__ = ["SyntheticTokenDataset"]
