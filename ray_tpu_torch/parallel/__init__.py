"""Training: the single-device counterpart of the JAX package's
``parallel/train_lib.py``."""

from .train_lib import (AdamW, ShardedTrainer, TrainState, WarmupCosine,
                        cross_entropy_loss, default_optimizer, masked_mean)

__all__ = ["AdamW", "ShardedTrainer", "TrainState", "WarmupCosine",
           "cross_entropy_loss", "default_optimizer", "masked_mean"]
