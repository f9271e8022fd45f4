"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu's compute, for NVIDIA
Hopper (H100). It imports torch and never JAX or the ray_tpu package.
So far it serves Llama models through the paged engine (``serve.llm``) and
trains them on one device (``parallel.train_lib.ShardedTrainer``).

Kernels are hand-written CUDA C++ under ``ops/csrc/``, built with nvcc on
first use (``ops/_build.py``); importing this package needs neither CUDA
nor a compiler.
"""

from .models.config import CONFIGS, LlamaConfig, get_config

__all__ = ["CONFIGS", "LlamaConfig", "get_config"]
