"""Execution policy: the per-platform choices of the device path.

Every choice that depends on where the computation runs is resolved here,
from the platform of the default device, and nowhere else:

* ``fused_sweep`` — the Pallas (Triton route) candidate-sweep kernels of
  :mod:`ecckd_tpu.ops.pallas` instead of the XLA form (f32 only);
* ``prefix_sums`` — once-per-band double-float prefix sums replacing each
  sweep's fit/truth interval-sum pass (f32, single device);
* ``band_parallel`` — find_g_points batches the probes of all bands into
  one dispatch (``band_parallel=auto``);
* ``auto_shard`` — find_g_points shards each band's wavenumber axis over
  all devices when there is more than one (``sharded=auto``);
* ``solver`` — optimize_lut's L-BFGS driver for ``solver=auto``.

The CPU keeps the bit-stable float64 path: no kernel, membership
reductions, serial bands, one device, scipy's L-BFGS-B.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class ExecutionPolicy:
    platform: str
    fused_sweep: bool = False
    prefix_sums: bool = False
    band_parallel: bool = False
    auto_shard: bool = False
    solver: str = "scipy"

    def sweep_kernel(self, dtype) -> bool:
        """Fused sweep kernel for operands of ``dtype``."""
        return self.fused_sweep and jnp.dtype(dtype) == jnp.float32

    def prefix(self, dtype) -> bool:
        """Per-band prefix sums for operands of ``dtype`` (single device)."""
        return self.prefix_sums and jnp.dtype(dtype) == jnp.float32


# GPU: the fused kernels and prefix sums won on an H100 and scipy's
# L-BFGS-B beat the on-device solver there (PERF.md); band batching and
# auto-sharding are carried over from the earlier design (one four-card
# run, compile-bound, showed no gain from sharding; PERF.md).
_POLICIES = {
    "gpu": ExecutionPolicy("gpu", fused_sweep=True, prefix_sums=True,
                           band_parallel=True, auto_shard=True,
                           solver="scipy"),
}


def default_platform() -> str:
    """Platform of the device that unpinned computations run on.

    Honours ``jax.default_device``: under ``with jax.default_device(cpu)``
    on a GPU host the default *backend* is still "gpu", but the
    computation runs on the CPU, where a GPU kernel cannot lower."""
    dev = jax.config.jax_default_device
    if dev is not None:
        return dev if isinstance(dev, str) else dev.platform
    return jax.default_backend()


def execution_policy(platform: Optional[str] = None) -> ExecutionPolicy:
    """The policy for ``platform`` (default: :func:`default_platform`)."""
    platform = default_platform() if platform is None else platform
    return _POLICIES.get(platform, ExecutionPolicy(platform))
