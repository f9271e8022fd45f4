"""Batch placement on the card: the counterpart of the JAX package's
``data.dataset.jax_batches``, for numpy dict batches (a Dataset's
``iter_batches``, a learner's batches)."""

from __future__ import annotations

from typing import Any, Dict, Iterable, Iterator, Mapping, Optional

import numpy as np
import torch


def device_batches(batches: Iterable[Mapping[str, Any]], *,
                   device: str = "cuda",
                   dtypes: Optional[Mapping[str, Any]] = None
                   ) -> Iterator[Dict[str, torch.Tensor]]:
    """numpy dict batches -> dicts of tensors on ``device`` (a column of
    ``dtypes`` is cast to its dtype on the host first).

    On a CUDA device each array is copied into pinned host memory and from
    there with ``non_blocking=True`` on the current stream. The copies are
    ordered before the batch is used because the work that uses it is
    queued on that same stream after them; a consumer on another stream
    must wait on the current one first. The pinned buffers stay referenced
    by the copies until they complete (the caching host allocator frees
    them after the stream's work), so nothing is overwritten in flight.
    On the CPU (``device="cpu"``) the arrays are wrapped as they are."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device_batches device is 'cuda' but no CUDA "
                           "device is available (pass device='cpu')")
    dtypes = dict(dtypes or {})
    for batch in batches:
        out = {}
        for key, val in batch.items():
            arr = np.asarray(val)
            if key in dtypes:
                arr = arr.astype(dtypes[key], copy=False)
            t = torch.from_numpy(np.ascontiguousarray(arr))
            if dev.type == "cuda":
                t = t.pin_memory().to(dev, non_blocking=True)
            out[key] = t
        yield out
