"""Training and meshes: the counterparts of the JAX package's
``parallel/`` (``train_lib``, ``pp_train``, ``mesh``, ``sharding``) and
the process-group bootstrap (``distributed``).

The trainer's names are imported on first use, so that the model may
import ``parallel.mesh`` while the trainer imports the model."""

_TRAIN_LIB = ("AdamW", "ShardedTrainer", "TrainState", "WarmupCosine",
              "cross_entropy_loss", "default_optimizer", "masked_mean")

__all__ = list(_TRAIN_LIB) + ["PipelinedTrainer"]


def __getattr__(name):
    if name in _TRAIN_LIB:
        from . import train_lib

        return getattr(train_lib, name)
    if name == "PipelinedTrainer":
        from .pp_train import PipelinedTrainer

        return PipelinedTrainer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
