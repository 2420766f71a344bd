from .pipeline import DataConfig, SyntheticLMDataset, sharded_batches

__all__ = ["DataConfig", "SyntheticLMDataset", "sharded_batches"]
