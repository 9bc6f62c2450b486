"""What the JAX package's device-mesh helpers (gigapose_tpu/parallel/mesh.py)
mean in the port.

The JAX package shards a batch over the devices of one process (test.py's
`make_mesh`, train.py's `best_dp_mesh`; with a view-sharded store, the
devices the store leaves over). The port runs one process per card instead:
data parallelism is processes (parallel/multihost.py: the CLIs split images
round-robin, the trainer steps its ranks as one global batch), and the one
thing sharded inside a process is the template store's view axis, over an
explicit list of devices (parallel/sharded_store.py). So `pad_to_multiple`
is kept, and `refuse_batch_mesh` raises where the JAX package would shard a
batch over several cards of one process.
"""

from __future__ import annotations

import torch

from gigapose_tpu_torch.parallel import multihost


def pad_to_multiple(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def refuse_batch_mesh(device_given: bool, store_shards: int = 1) -> None:
    """Raise where the JAX package would shard the batch over several cards
    of one process: one process, no device named, and more visible cards
    than `store_shards` uses (JAX's batch axis: cards // store_shards). A
    named device, a multi-process run or one card passes."""
    if device_given or multihost.process_count() > 1 or not torch.cuda.is_available():
        return
    cards = torch.cuda.device_count() // max(store_shards, 1)
    if cards > 1:
        raise NotImplementedError(
            f"{torch.cuda.device_count()} cards in one process: the JAX package shards the "
            f"batch over {cards} of them; the port runs one process per card. Launch one "
            "process per card (GIGAPOSE_COORDINATOR / GIGAPOSE_NUM_PROCESSES / "
            "GIGAPOSE_PROCESS_ID, or torchrun with GIGAPOSE_DISTRIBUTED=1), or name one "
            "card with device=cuda:N")
