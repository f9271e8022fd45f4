"""Attention ops: the CUDA kernels (``csrc/``) and their plain PyTorch
versions. Import the submodules (``attention``, ``flash_attention``,
``paged_attention``); nothing is re-exported here, so the function
``flash_attention`` never shadows the module of the same name."""
