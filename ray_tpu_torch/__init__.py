"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu's compute, for NVIDIA
Hopper (H100). It imports torch and never JAX or the ray_tpu package.
It serves Llama and Mixtral-style models through the paged engine
(``serve.llm``), on one device, a tensor-parallel mesh or pipeline stages
(``serve.llm.pp``), and trains them
(``parallel.train_lib.ShardedTrainer``) on one device or a mesh of the six
JAX axes, sequence parallelism included, and in pipeline stages
(``parallel.pp_train.PipelinedTrainer``), saving and resuming a trainer's
state on any layout (``train.checkpoint``). It runs the RL learners'
compute (``rllib``: modules, every algorithm's learner, the acting
step), the JAX entry point's forward step (``entry.entry``), and places
numpy batches on the card (``data.device_batches``).

Kernels are hand-written CUDA C++ under ``ops/csrc/``, built with nvcc on
first use (``ops/_build.py``); importing this package needs neither CUDA
nor a compiler.
"""

from .models.config import CONFIGS, LlamaConfig, get_config

__all__ = ["CONFIGS", "LlamaConfig", "get_config"]
