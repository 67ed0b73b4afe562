"""Data pipelines of the port (counterpart of `repro.data`)."""
from repro_torch.data.tokens import SyntheticTokenDataset, make_lm_batch
from repro_torch.data.trajectory import batch_trajectories, episode_returns

__all__ = ["SyntheticTokenDataset", "make_lm_batch", "batch_trajectories", "episode_returns"]
