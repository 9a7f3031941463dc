"""Multi-host setup and per-host corpus sharding.

The reference's "other target that needs its own launcher" was a manual
RISC-V flow (SURVEY.md §2b); here every host runs the same program,
``jax.distributed.initialize`` wires the processes together, and each host
reads only its own shard of the corpus (data loading stays on local disk;
the network carries only CMVN stats).
"""

from __future__ import annotations

import jax


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_device_ids: list[int] | None = None) -> None:
    """Initialize multi-process JAX.  No-op for single-process runs.

    Nothing tells JAX of a GPU cluster, so multi-process runs pass the
    coordinator (``host:port``), the process count and this process's id.
    By default one process owns all of its host's GPUs, which is what
    ``runner.run`` expects (it shards each batch over the local devices).
    ``local_device_ids`` pins this process to those GPUs instead, e.g.
    ``[process_id]`` for one process per GPU on a single host.
    """
    if num_processes is not None and num_processes > 1 or coordinator_address:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids,
        )


def host_shard(items: list, process_index: int | None = None,
               process_count: int | None = None) -> list:
    """Deterministic per-host shard of a corpus listing (strided split,
    balancing utterance order across hosts)."""
    pi = jax.process_index() if process_index is None else process_index
    pc = jax.process_count() if process_count is None else process_count
    return items[pi::pc]


def is_coordinator() -> bool:
    return jax.process_index() == 0
