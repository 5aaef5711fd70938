"""Device-mesh and sharding utilities.

The framework's scaling axes (SURVEY.md §5):

* ``spectral`` — the wavenumber dimension (up to ~5.6M points).  Every
  wavenumber is independent in the two-stream RT, so spectra are sharded
  across chips and g-point integrals / broadband sums / cost gradients
  reduce with psum over this axis.  This replaces the reference's
  streaming-from-disk handling of the spectral dimension.
* ``data`` — training profiles/columns in optimize_lut (data parallel);
  the LUT pytree is replicated and XLA inserts the gradient psum.

The reference has no distributed backend (OpenMP only); these utilities are
the equivalent built on jax.sharding + XLA collectives.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def make_mesh(n_devices: Optional[int] = None,
              data_parallel: Optional[int] = None):
    """Create a (data, spectral) mesh over the available devices.

    With ``data_parallel`` unset, devices split between the two axes as
    evenly as possible (favouring spectral, the larger dimension in
    practice).
    """
    import jax
    from jax.sharding import Mesh

    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if data_parallel is None:
        # Largest power-of-two split <= sqrt(n)
        data_parallel = 1
        while (data_parallel * 2 <= n // (data_parallel * 2)
               and n % (data_parallel * 2) == 0):
            data_parallel *= 2
    if n % data_parallel:
        raise ValueError(f"{n} devices not divisible by data_parallel="
                         f"{data_parallel}")
    spectral = n // data_parallel
    dev_array = np.asarray(devices).reshape(data_parallel, spectral)
    return Mesh(dev_array, axis_names=("data", "spectral"))


def profile_sharding(mesh, ndim: int = 2, axis: int = 0):
    """NamedSharding placing the profile axis across the whole mesh
    (data x spectral flattened) with other axes replicated."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    spec = [None] * ndim
    spec[axis] = ("data", "spectral")
    return NamedSharding(mesh, P(*spec))


def spectral_sharding(mesh, ndim: int = 2, axis: int = -1):
    """NamedSharding placing the wavenumber axis across the 'spectral'
    mesh axis."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    spec = [None] * ndim
    spec[axis % ndim] = "spectral"
    return NamedSharding(mesh, P(*spec))


def replicated(mesh):
    from jax.sharding import NamedSharding, PartitionSpec as P
    return NamedSharding(mesh, P())


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
