"""ecckd_tpu: a JAX correlated k-distribution (CKD) gas-optics generator.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of ecCKD
(ecmwf-ifs/ecckd): generation of correlated k-distribution gas-optics models
from high-resolution line-by-line absorption spectra, comprising

* spectral reordering (``tools.reorder_spectrum``),
* g-point partitioning by equipartition of a radiative cost metric
  (``tools.find_g_points``),
* look-up-table construction by spectral averaging (``tools.create_lut``),
* LUT refinement by autodiff L-BFGS against line-by-line fluxes
  (``tools.optimize_lut``), and
* CKD model evaluation (``tools.run_ckd``).

The compute path is pure JAX (jit/vmap/grad + Pallas kernels) and runs on
GPUs: the spectral (wavenumber) axis is the scaling dimension and is sharded
across a device mesh; g-point reductions are segment-sum matmuls; the
two-stream layer recurrences are short scans vectorized over the spectral
axis; Adept reverse-mode autodiff is replaced by ``jax.value_and_grad`` of a
pure cost function over a pytree of look-up tables.
"""

__version__ = "0.1.0"
