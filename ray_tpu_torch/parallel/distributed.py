"""The process-group bootstrap: one process per rank.

The counterpart of the JAX package's worker-group setup
(``train/worker_group.py``: ``jax.distributed.initialize`` behind a
coordinator address) and of its torch backend (``train/torch.py``, gloo).
The runtime's worker group (actors, the cluster KV) is not ported: this
package may not import the runtime.

``init_process_group`` joins the world of the calling process: NCCL for a
CUDA device (with its ``device_id``), gloo for the CPU. ``spawn`` starts a
world of ``world_size`` local processes, runs a function on every rank
and returns each rank's result.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import tempfile
import time
import traceback
from typing import Any, Callable, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

# modules the spawn server imports once, so that a rank starts by a fork
# of it instead of importing torch anew (several seconds a process);
# fully_shard imports torch._dynamo on its first call
_PRELOAD = ["torch", "torch._dynamo", "torch.distributed.fsdp",
            "ray_tpu_torch.entry"]


def init_process_group(device="cuda", *, rank: Optional[int] = None,
                       world_size: Optional[int] = None,
                       init_method: Optional[str] = None,
                       store: Optional[dist.Store] = None,
                       timeout_s: float = 600.0) -> torch.device:
    """Join the world: rank and world size from the arguments or from the
    environment (``RANK``, ``WORLD_SIZE``; the address from
    ``init_method``, a ``store``, or ``MASTER_ADDR``/``MASTER_PORT``).
    NCCL for ``device`` "cuda" (the rank's card is ``LOCAL_RANK``, else
    the rank modulo the cards), gloo for "cpu". Returns the rank's device.
    """
    device = torch.device(device)
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                  else world_size)
    if store is None and init_method is None:
        init_method = "env://"
    kwargs = dict(rank=rank, world_size=world_size, store=store,
                  init_method=init_method,
                  timeout=datetime.timedelta(seconds=timeout_s))
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_process_group: device 'cuda' but no "
                               "CUDA device is available")
        index = device.index
        if index is None:
            index = int(os.environ.get("LOCAL_RANK",
                                       rank % torch.cuda.device_count()))
        device = torch.device("cuda", index)
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", device_id=device, **kwargs)
    elif device.type == "cpu":
        dist.init_process_group("gloo", **kwargs)
    else:
        raise ValueError(f"no process-group backend for device {device}")
    return device


def _rank_main(fn, args, kwargs, rank: int, world_size: int, device: str,
               store_path: str, out_path: str, timeout_s: float) -> None:
    """One rank: join the world through the file store, run
    ``fn(*args, **kwargs)`` and write ("ok", result) or ("error",
    traceback) to ``out_path``."""
    try:
        torch.set_num_threads(1)
        store = dist.FileStore(store_path, world_size)
        init_process_group(device if device == "cpu" else
                           torch.device(device, rank), rank=rank,
                           world_size=world_size, store=store,
                           timeout_s=timeout_s)
        try:
            out = ("ok", fn(*args, **kwargs))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises
        out = ("error", traceback.format_exc())
    with open(out_path + ".tmp", "wb") as f:
        pickle.dump(out, f)
    os.replace(out_path + ".tmp", out_path)


def spawn(fn: Callable, world_size: int, device: str = "cuda",
          timeout_s: float = 120.0, args: Sequence = (),
          kwargs: Optional[Mapping[str, Any]] = None) -> List[Any]:
    """Run ``fn(*args, **kwargs)`` on every rank of a new world of
    ``world_size`` local processes (gloo for "cpu", NCCL on one card a rank
    for "cuda") and return the ranks' results in rank order. ``fn`` and
    its arguments are pickled: ``fn`` is a module-level function.

    The ranks meet through a ``FileStore`` in a temporary directory (no
    port), so worlds can run side by side. Processes fork from a server
    that has imported torch once (``multiprocessing``'s forkserver: a
    single-threaded process, so the fork is safe). A rank that raises
    fails the call with its traceback; a world that has not finished
    within ``timeout_s`` seconds of the start is killed and fails it
    too."""
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(_PRELOAD)
    deadline = time.monotonic() + timeout_s
    with tempfile.TemporaryDirectory(prefix="rtpu_world_") as tmp:
        outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(world_size)]
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, tuple(args), dict(kwargs or {}), r,
                                   world_size, device,
                                   os.path.join(tmp, "store"), outs[r],
                                   timeout_s))
                 for r in range(world_size)]
        try:
            for p in procs:
                p.start()
            results = _wait(procs, outs, deadline, timeout_s)
        finally:
            for p in procs:
                if p.pid is None:  # never started
                    continue
                if p.is_alive():
                    p.kill()
                p.join(5)
    return results


def _wait(procs, outs, deadline, timeout_s) -> List[Any]:
    """Each rank's result; raises at the first rank that failed, or when
    the deadline passes."""
    results = [None] * len(procs)
    pending = set(range(len(procs)))
    while pending:
        for r in sorted(pending):
            if os.path.exists(outs[r]):
                with open(outs[r], "rb") as f:
                    status, value = pickle.load(f)
                if status == "error":
                    raise RuntimeError(f"rank {r} of {len(procs)} failed:\n"
                                       f"{value}")
                results[r] = value
                pending.discard(r)
            elif not procs[r].is_alive() and procs[r].exitcode is not None \
                    and not os.path.exists(outs[r]):
                raise RuntimeError(f"rank {r} of {len(procs)} exited with "
                                   f"code {procs[r].exitcode} and no result")
        if pending and time.monotonic() > deadline:
            raise TimeoutError(f"ranks {sorted(pending)} of {len(procs)} "
                               f"had not finished after {timeout_s} s")
        if pending:
            time.sleep(0.01)
    return results
