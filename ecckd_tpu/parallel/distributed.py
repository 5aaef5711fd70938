"""Multi-host initialization helpers.

The reference has no distributed backend (OpenMP only); the new framework
scales across hosts with jax.distributed + a global mesh over the device interconnect
(SURVEY.md §5).  This module wraps the initialization boilerplate so tools
can run unchanged under a multi-host launcher:

    from ecckd_tpu.parallel import distributed
    distributed.initialize_from_env()   # no-op single-host

Collectives used by the framework are psum (g-point integrals, cost,
gradient — inserted automatically by XLA for replicated-parameter
gradients), all_gather (assembled LUT/bounds — small), and host streaming of
spectral shards per host overlapping compute (io/shards.py).
"""

from __future__ import annotations

import os
from typing import Optional

from .. import logs


def initialize_from_env(coordinator_address: Optional[str] = None,
                        num_processes: Optional[int] = None,
                        process_id: Optional[int] = None) -> bool:
    """Initialize jax.distributed from args or standard env variables.

    Recognizes JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID
    (and falls back to jax.distributed.initialize() auto-detection on
    managed clusters).  Returns True when multi-process mode was initialized.
    """
    import jax

    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])

    if coordinator_address is None and num_processes is None:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes, process_id=process_id)
    logs.log(f"jax.distributed initialized: process "
             f"{jax.process_index()}/{jax.process_count()}, "
             f"{jax.local_device_count()} local of "
             f"{jax.device_count()} global devices")
    return True


def local_shard_range(n_items: int) -> range:
    """This host's contiguous slice of a globally-partitioned work list
    (e.g. spectral shard files): the multi-host analogue of the reference's
    one-profile-at-a-time streaming."""
    import jax
    pid, nproc = jax.process_index(), jax.process_count()
    per = -(-n_items // nproc)
    return range(pid * per, min((pid + 1) * per, n_items))
