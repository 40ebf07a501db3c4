"""Multi-process wiring (counterpart of
the JAX package's ``parallel/distributed.py``).

One process per GPU over ``torch.distributed``: NCCL between GPUs, gloo
on the CPU.  :func:`initialize_from_env` keeps the JAX package's triggers
and their order, so every entry point can call it unconditionally:

- ``SMHPSS_DISTRIBUTED=1``: torchrun's environment (``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``),
  ``init_method='env://'``;
- ``JAX_COORDINATOR_ADDRESS`` (``host:port``) with ``JAX_NUM_PROCESSES``
  and ``JAX_PROCESS_ID``: ``init_method='tcp://host:port'``;
- neither: one process, nothing is initialized.

Each process then reads its own shard of the corpus
(:func:`process_file_shard`) and draws from its own seed
(:func:`per_process_seed`); the model's weights stay seeded alike
(``parallel.dp`` broadcasts them from rank 0 all the same).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def backend() -> str:
    """NCCL where a GPU is visible, gloo on the CPU."""
    return "nccl" if torch.cuda.is_available() else "gloo"


def initialize_from_env() -> bool:
    """Initialize the default process group when the environment asks for
    it (module doc); return True iff more than one process runs
    afterwards.  Idempotent: a second call, or a group initialized
    elsewhere, initializes nothing."""
    if not dist.is_initialized():
        coord = os.environ.get("JAX_COORDINATOR_ADDRESS")
        if os.environ.get("SMHPSS_DISTRIBUTED") == "1" and not coord:
            kw = dict(init_method="env://")
        elif coord:
            kw = dict(init_method=f"tcp://{coord}",
                      world_size=int(os.environ["JAX_NUM_PROCESSES"]),
                      rank=int(os.environ["JAX_PROCESS_ID"]))
        else:
            return False
        name = backend()
        if name == "nccl":
            r = int(os.environ.get("RANK", kw.get("rank", 0)))
            local = int(os.environ.get("LOCAL_RANK",
                                       r % torch.cuda.device_count()))
            torch.cuda.set_device(local)
        dist.init_process_group(backend=name, **kw)
    return dist.get_world_size() > 1


def rank() -> int:
    """This process's rank in the default group; 0 in one process."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """Processes in the default group; 1 in one process."""
    return dist.get_world_size() if dist.is_initialized() else 1


def per_process_seed(seed: int) -> int:
    """``seed`` strided by the process's rank (100 003 apart, as the JAX
    package), so that each process's batcher draws other files and
    patches; the identity in one process."""
    return seed + 100_003 * rank()


def process_file_shard(files: dict[str, list], *,
                       process_index: int | None = None,
                       process_count: int | None = None) -> dict[str, list]:
    """Per-class round-robin shard of a ``{class: [files...]}`` dict for
    this process (a copy of the JAX package's function).

    Multi-host data loading: each host reads only its own slice of the
    corpus (strided, so class balance and genre spread survive the split).
    Classes with fewer files than processes fall back to the full list —
    a short class must still appear in every host's balanced stream.
    """
    idx = rank() if process_index is None else process_index
    cnt = world_size() if process_count is None else process_count
    if cnt <= 1:
        return files
    out = {}
    for cls, lst in files.items():
        lst = list(lst)
        shard = lst[idx::cnt]
        out[cls] = shard if shard else lst
    return out
