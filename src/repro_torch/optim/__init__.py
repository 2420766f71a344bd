from .adamw import AdamWConfig, global_norm, init, update
from .schedule import warmup_cosine, wsd

__all__ = ["AdamWConfig", "global_norm", "init", "update", "warmup_cosine", "wsd"]
