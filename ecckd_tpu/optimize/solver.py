"""Bounded L-BFGS driver for LUT optimization.

Equivalent of solve_adept (src/ecckd/solve_adept.cpp:309-419):
the state is log(k) per active gas (MIN_X sentinel holding exact zeros at
zero), bounds come from the min/max LUT arrays with the reference's zero-min
fixups, and each iteration evaluates ONE jit-compiled value_and_grad of the
full training cost on device.  The L-BFGS update itself is a tiny O(n_state)
host-side computation (scipy L-BFGS-B), negligible next to the radiative
transfer; the heavy lifting (cost + gradient over all scenes/profiles)
happens in a single XLA executable per scene shape.
"""

from __future__ import annotations

import dataclasses
import enum
import os
import time
from typing import Dict, List, Optional

import numpy as np

from .. import logs
from .cost_fn import (MIN_X, SceneArrays, SceneMeta, build_scene,
                      make_cost_fn, make_prior_fn)


class MinimizerStatus(enum.Enum):
    SUCCESS = 0
    MAX_ITERATIONS_REACHED = 1
    FAILED = 2
    INVALID_COST_FUNCTION = 3

    def describe(self):
        return {
            MinimizerStatus.SUCCESS: "Converged",
            MinimizerStatus.MAX_ITERATIONS_REACHED:
                "Maximum iterations reached",
            MinimizerStatus.FAILED: "Failed to converge",
            MinimizerStatus.INVALID_COST_FUNCTION: "Invalid cost function",
        }[self]


def log_state_tree(model) -> Dict[str, np.ndarray]:
    """Log-space state with MIN_X sentinel for zeros
    (ref solve_adept.cpp:335-340)."""
    tree = {}
    for mol, k in model.active_lut_pytree().items():
        k = np.asarray(k, np.float64)
        with np.errstate(divide="ignore"):
            x = np.where(k > 0.0, np.log(np.where(k > 0.0, k, 1.0)), MIN_X)
        tree[mol] = x
    return tree


def state_bounds(model) -> (Dict[str, np.ndarray], Dict[str, np.ndarray]):
    """Log-space bounds from min/max LUTs with zero-min fixups
    (ref solve_adept.cpp:344-377 and ChangeLog v1.5)."""
    x_min_tree, x_max_tree = {}, {}
    for g in model.single_gas_data:
        if not g.is_active:
            continue
        k = np.asarray(g.molar_abs, np.float64)
        kmin = g.min_molar_abs
        kmax = g.max_molar_abs
        lo = np.full(k.shape, -np.inf)
        hi = np.full(k.shape, np.inf)
        if kmin is not None:
            with np.errstate(divide="ignore"):
                x = np.where(k > 0.0, np.log(np.where(k > 0, k, 1)), MIN_X)
                x_max = np.where(kmax > 0.0,
                                 np.log(np.where(kmax > 0, kmax, 1)), np.inf)
                x_min = np.where(kmin > 0.0,
                                 np.log(np.where(kmin > 0, kmin, 1)),
                                 -np.inf)
            # Where min is zero but k>0, widen: twice as far below (log) as
            # x_max is above x, capped at x_max-1
            fix = (kmin == 0.0) & (k > 0.0) & (kmax > 0.0)
            x_min = np.where(fix, np.minimum(3.0 * x - 2.0 * x_max,
                                             x_max - 1.0), x_min)
            bad = (kmax > 0.0) & (x_min >= x_max)
            nbad = int(bad.sum())
            if nbad:
                logs.warning(f"{nbad} bounds on the state variables have "
                             "x_min>=x_max")
                x_min = np.where(bad, x_max - 1.0, x_min)
            lo, hi = x_min, x_max
        x_min_tree[g.molecule] = lo
        x_max_tree[g.molecule] = hi
    if model.rayleigh_is_active:
        k = np.asarray(model.rayleigh_molar_scat, np.float64)
        x_min_tree["rayleigh"] = np.full(k.shape, -np.inf)
        x_max_tree["rayleigh"] = np.full(k.shape, np.inf)
    return x_min_tree, x_max_tree


def _shard_scene_profiles(scene, meta):
    """Shard every per-profile array of a scene across ALL devices.

    A non-divisible profile count is padded to the device multiple by
    repeating the last profile; padded copies carry zero
    ``meta.profile_weight`` so sums are unbiased while every chip stays
    busy (previously devices were dropped one at a time — 50 profiles on 8
    chips ran on only 5).
    """
    import dataclasses as _dc
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P, Mesh
    import numpy as _np

    devices = jax.devices()
    ncol = scene.pressure_hl.shape[0]
    n = len(devices)
    if n <= 1:
        return scene, meta
    pad = (-ncol) % n
    mesh = Mesh(_np.asarray(devices), axis_names=("data",))
    out = {}
    for name, arr in scene._asdict().items():
        if arr is None:
            out[name] = None
            continue
        a = jnp.asarray(arr)
        if a.ndim >= 1 and a.shape[0] == ncol:
            if pad:
                a = jnp.concatenate([a] + [a[-1:]] * pad, axis=0)
            sharding = NamedSharding(mesh, P("data"))
        else:
            sharding = NamedSharding(mesh, P())
        out[name] = jax.device_put(a, sharding)
    if pad:
        pw = (_np.ones(ncol + pad) if meta.profile_weight is None
              else _np.concatenate([meta.profile_weight, _np.ones(pad)]))
        pw[ncol:] = 0.0
        meta = _dc.replace(meta, profile_weight=pw)
    return type(scene)(**out), meta


def _save_checkpoint(path: str, tree, n_iter: int, cost: float):
    """Atomically write optimizer state (the log-LUT pytree + iteration
    count). SURVEY.md §5: the reference has no intra-optimization
    checkpointing (an L-BFGS run is atomic); here long runs can resume."""
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as f:
        np.savez(f, _n_iter=np.int64(n_iter), _cost=np.float64(cost),
                 **{f"state_{k}": np.asarray(v) for k, v in tree.items()})
    os.replace(tmp, path)


def _remove_checkpoint(path: str):
    """Drop a completed run's checkpoint so a forced rerun starts clean."""
    try:
        os.remove(path)
    except OSError:
        pass


def _load_checkpoint(path: str, expect_tree):
    """Load a checkpoint if present and shape-compatible, else None."""
    if not path or not os.path.exists(path):
        return None
    with np.load(path) as ck:
        tree = {k[len("state_"):]: np.asarray(ck[k]) for k in ck.files
                if k.startswith("state_")}
        n_iter = int(ck["_n_iter"])
    if set(tree) != set(expect_tree) or any(
            tree[k].shape != np.asarray(expect_tree[k]).shape
            for k in tree):
        logs.warning(f"Checkpoint {path} does not match the state layout; "
                     "ignoring it")
        return None
    return tree, n_iter


def _solve_on_device(total_cost, x0_tree, lo_tree, hi_tree, sentinel_tree,
                     max_iterations, gtol, chunk=100, on_chunk=None):
    """Fully on-device L-BFGS: the whole minimization loop (two-loop
    recursion + zoom line search via optax.lbfgs) runs inside jitted
    ``lax.while_loop`` chunks, so a dispatch covers ``chunk`` iterations
    instead of one — the per-iteration host round trip disappears from the
    critical path.

    Bounds are enforced by projection after each update (a projected
    L-BFGS; the scipy path implements the reference's exact L-BFGS-B
    active-set behavior, solve_adept.cpp:411-415).  Sentinel (log-zero)
    entries have their gradients zeroed and values re-pinned, matching the
    MIN_X handling of solve_adept.cpp:240-249.
    """
    import jax
    import jax.numpy as jnp
    import optax

    sentinels = {k: jnp.asarray(v) for k, v in sentinel_tree.items()}
    x0 = {k: jnp.asarray(v) for k, v in x0_tree.items()}
    bounded = lo_tree is not None
    if bounded:
        lo = {k: jnp.asarray(v) for k, v in lo_tree.items()}
        hi = {k: jnp.asarray(v) for k, v in hi_tree.items()}

    def constrain(params):
        if bounded:
            params = jax.tree.map(jnp.clip, params, lo, hi)
        # Re-pin sentinel entries exactly
        return jax.tree.map(lambda p, x, s: jnp.where(s, x, p),
                            params, x0, sentinels)

    def masked_grad(g):
        return jax.tree.map(lambda gg, s: jnp.where(s, 0.0, gg),
                            g, sentinels)

    opt = optax.lbfgs(memory_size=30)
    value_and_grad = jax.value_and_grad(total_cost)

    def gnorm_of(g):
        return jnp.max(jnp.asarray(
            [jnp.max(jnp.abs(leaf)) for leaf in jax.tree.leaves(g)]))

    def body(carry):
        params, state, it, _, _ = carry
        value, grad = value_and_grad(params)
        grad = masked_grad(grad)
        updates, state = opt.update(grad, state, params, value=value,
                                    grad=grad, value_fn=total_cost)
        params = constrain(optax.apply_updates(params, updates))
        return params, state, it + 1, value, gnorm_of(grad)

    def cond_to(limit):
        def cond(carry):
            _, _, it, value, gnorm = carry
            return ((it < limit) & (gnorm > gtol)
                    & jnp.isfinite(value))
        return cond

    @jax.jit
    def run_chunk(carry, limit):
        return jax.lax.while_loop(cond_to(limit), body, carry)

    params = constrain(x0)
    state = opt.init(params)
    carry = (params, state, jnp.int32(0), jnp.asarray(0.0),
             jnp.asarray(jnp.inf))
    it = 0
    while it < max_iterations:
        limit = min(it + chunk, max_iterations)
        carry = run_chunk(carry, jnp.int32(limit))
        params, state, it_dev, value, gnorm = carry
        new_it = int(it_dev)
        logs.progress(f"Iteration {new_it}: cost = {float(value):.6g}, "
                      f"gradient norm = {float(gnorm):.6g}")
        if on_chunk is not None:
            on_chunk({k: np.asarray(v) for k, v in params.items()},
                     new_it, float(value))
        if new_it < limit or not np.isfinite(float(value)):
            break   # converged (or failed) inside the chunk
        it = new_it

    params, state, it_dev, value, gnorm = carry
    return ({k: np.asarray(v) for k, v in params.items()},
            float(value), int(it_dev), float(gnorm))


@dataclasses.dataclass
class SolveResult:
    status: MinimizerStatus
    cost: float
    n_iterations: int
    n_evaluations: int
    gradient_norm: float
    wall_time: float
    seconds_per_iteration: float


def solve(model, training_data, flux_weight=0.02, flux_profile_weight=0.0,
          broadband_weight=0.5, spectral_boundary_weight=0.0,
          erythemal_weight=0.0, prior_error=-1.0, max_iterations=3000,
          convergence_criterion=0.02, negative_od_penalty=1.0e4,
          pressure_weight_power=0.5, is_bounded=True,
          relative_fluxes=None, data_parallel=False,
          solver="auto", checkpoint_file=None,
          checkpoint_every=0) -> SolveResult:
    """Optimize the active gases' LUTs against LBL training fluxes.

    ``training_data`` is a list of LblFluxes; the model is updated in place.
    With ``data_parallel`` and more than one device, per-profile scene
    arrays are sharded across all devices (the LUT pytree stays replicated,
    so XLA psums the gradients over the mesh).

    ``solver``: "scipy" (host L-BFGS-B around the jitted device
    value_and_grad — the reference's exact bounded behavior), "device"
    (the entire L-BFGS loop on device via optax; bounds by projection;
    eliminates the per-iteration host round trip), or "auto" (the
    execution policy's choice for the default device,
    :mod:`ecckd_tpu.policy`).  Device-vs-scipy final-cost parity is
    asserted in tests/test_optimize.py.
    """
    import jax
    import jax.numpy as jnp
    from jax.flatten_util import ravel_pytree
    from scipy.optimize import minimize
    from ..ops.cost import CostWeights
    from ..logs import Timer

    if solver == "auto":
        from ..policy import execution_policy
        solver = execution_policy().solver

    weights = CostWeights(
        flux_weight=flux_weight, flux_profile_weight=flux_profile_weight,
        broadband_weight=broadband_weight,
        spectral_boundary_weight=spectral_boundary_weight)

    scenes = []
    for ilbl, lbl in enumerate(training_data):
        rel = None
        if relative_fluxes is not None:
            rel = relative_fluxes[ilbl]
        scenes.append(build_scene(model, lbl,
                                  pressure_weight_power=pressure_weight_power,
                                  erythemal_weight=erythemal_weight,
                                  relative_fluxes=rel))

    if data_parallel and len(jax.devices()) > 1:
        scenes = [_shard_scene_profiles(scene, meta)
                  for scene, meta in scenes]

    data_cost = make_cost_fn(model, scenes, weights,
                             negative_od_penalty=negative_od_penalty)
    prior_cost = make_prior_fn(model)

    x0_tree = log_state_tree(model)
    # The prior background is the model state as read from the input file,
    # NOT a resumed checkpoint state (ckd_model.cpp:838-877 semantics).
    prior_tree = {k: v.copy() for k, v in x0_tree.items()}

    # Resume a long optimization from its periodic state checkpoint.  The
    # iteration budget counts TOTAL iterations: a resumed run performs at
    # most max_iterations - it_offset further iterations.
    it_offset = 0
    if checkpoint_file:
        resumed = _load_checkpoint(checkpoint_file, x0_tree)
        if resumed is not None:
            x0_tree, it_offset = resumed
            logs.log(f"Resuming optimization from {checkpoint_file} "
                     f"(iteration {it_offset})")
    max_local = max(0, max_iterations - it_offset)

    last_saved = [it_offset]

    def _maybe_checkpoint(tree, n_iter, cost):
        """Save at most every checkpoint_every TOTAL iterations (the device
        path reports progress in ~100-iteration chunks; a save happens at
        the first chunk boundary that crosses the next multiple)."""
        if (checkpoint_file and checkpoint_every > 0
                and n_iter - last_saved[0] >= checkpoint_every):
            _save_checkpoint(checkpoint_file, tree, n_iter, cost)
            last_saved[0] = n_iter

    def total_cost(tree):
        return data_cost(tree) + prior_cost(tree, prior_tree)

    if solver == "device":
        sentinel_tree = {k: np.asarray(v) <= MIN_X
                         for k, v in x0_tree.items()}
        lo_tree = hi_tree = None
        if is_bounded:
            lo_tree, hi_tree = state_bounds(model)
            logs.log("  Minimization is bounded (projection on device)")
        logs.log(f"Optimizing coefficients with ON-DEVICE L-BFGS: max "
                 f"iterations = {max_iterations}, convergence criterion = "
                 f"{convergence_criterion}")
        t0 = time.perf_counter()
        tree_final, cost, n_iter_local, gnorm = _solve_on_device(
            total_cost, x0_tree, lo_tree, hi_tree, sentinel_tree,
            max_local, convergence_criterion,
            on_chunk=lambda tree, it, c: _maybe_checkpoint(
                tree, it + it_offset, c))
        n_iter_dev = n_iter_local + it_offset
        wall = time.perf_counter() - t0
        k_tree = {mol: np.where(v > MIN_X, np.exp(v), 0.0)
                  for mol, v in tree_final.items()}
        model.set_active_lut_pytree(k_tree)
        if not np.isfinite(cost):
            status = MinimizerStatus.INVALID_COST_FUNCTION
        elif gnorm <= convergence_criterion:
            status = MinimizerStatus.SUCCESS
        elif n_iter_local >= max_local:
            status = MinimizerStatus.MAX_ITERATIONS_REACHED
        else:
            status = MinimizerStatus.FAILED
        logs.log(f"Final cost function = {cost:.6g} after {n_iter_dev} "
                 f"iterations, {wall:.1f} s "
                 f"({wall / max(n_iter_dev, 1):.4f} s/iter)")
        if status == MinimizerStatus.SUCCESS and checkpoint_file:
            _remove_checkpoint(checkpoint_file)
        return SolveResult(
            status=status, cost=cost, n_iterations=n_iter_dev,
            n_evaluations=n_iter_dev, gradient_norm=gnorm, wall_time=wall,
            seconds_per_iteration=wall / max(n_iter_dev, 1))

    value_and_grad = jax.jit(jax.value_and_grad(total_cost))

    x0_flat, unravel = ravel_pytree(
        {k: jnp.asarray(v) for k, v in x0_tree.items()})
    x0_flat = np.asarray(x0_flat)
    sentinel_mask = x0_flat <= MIN_X

    bounds = None
    if is_bounded:
        lo_tree, hi_tree = state_bounds(model)
        lo_flat = np.asarray(ravel_pytree(
            {k: jnp.asarray(v) for k, v in lo_tree.items()})[0])
        hi_flat = np.asarray(ravel_pytree(
            {k: jnp.asarray(v) for k, v in hi_tree.items()})[0])
        # Sentinel entries are held fixed
        lo_flat = np.where(sentinel_mask, x0_flat, lo_flat)
        hi_flat = np.where(sentinel_mask, x0_flat, hi_flat)
        lo_flat = np.where(np.isfinite(lo_flat), lo_flat, None)
        hi_flat = np.where(np.isfinite(hi_flat), hi_flat, None)
        bounds = list(zip(lo_flat, hi_flat))
        n_lo = sum(1 for b in bounds if b[0] is not None)
        n_hi = sum(1 for b in bounds if b[1] is not None)
        logs.log(f"  Minimization is bounded: {n_lo} lower, {n_hi} upper "
                 f"bounds out of {len(bounds)} state variables")
    else:
        logs.log("  Minimization is unbounded")

    logs.log(f"Optimizing coefficients with L-BFGS: max iterations = "
             f"{max_iterations}, convergence criterion = "
             f"{convergence_criterion}")
    logs.log("  CKD model interpolation is "
             + ("LOGARITHMIC" if model.logarithmic_interpolation
                else "LINEAR"))

    n_eval = [0]
    last_grad_norm = [np.inf]
    last_val = [np.inf]
    t0 = time.perf_counter()
    # Named-activity breakdown matching the reference's Timer split
    # (solve_adept.cpp:214-231): device cost+gradient vs host minimizer
    timer = Timer()
    timer.start("minimizer")

    def fun(x_flat):
        timer.start("cost function + gradient (device)")
        tree = unravel(jnp.asarray(x_flat))
        val, grad = value_and_grad(tree)
        grad_flat = np.array(ravel_pytree(grad)[0], np.float64, copy=True)
        timer.start("minimizer")
        # Hold sentinels fixed; flush tiny gradients
        # (ref solve_adept.cpp:276-286)
        grad_flat[sentinel_mask] = 0.0
        grad_flat[np.abs(grad_flat) < 1.0e-80] = 0.0
        n_eval[0] += 1
        last_grad_norm[0] = np.abs(grad_flat).max()
        last_val[0] = float(val)
        return float(val), grad_flat

    n_iter = [0]

    def report(x_flat):
        n_iter[0] += 1
        if n_iter[0] % 10 == 1 or n_iter[0] < 5:
            logs.progress(f"Iteration {n_iter[0]}: gradient norm = "
                          f"{last_grad_norm[0]:.6g}")
        if (checkpoint_file and checkpoint_every > 0
                and n_iter[0] % checkpoint_every == 0):
            tree = unravel(jnp.asarray(x_flat))
            _maybe_checkpoint({k: np.asarray(v) for k, v in tree.items()},
                              n_iter[0] + it_offset, last_val[0])

    result = minimize(
        fun, x0_flat, jac=True, method="L-BFGS-B", bounds=bounds,
        callback=report,
        options=dict(maxiter=max_local, gtol=convergence_criterion,
                     ftol=1e-14, maxcor=30))
    wall = time.perf_counter() - t0

    x_final = np.asarray(result.x)
    tree_final = unravel(jnp.asarray(x_final))
    k_tree = {mol: np.where(np.asarray(v) > MIN_X,
                            np.exp(np.asarray(v)), 0.0)
              for mol, v in tree_final.items()}
    model.set_active_lut_pytree(k_tree)

    if not np.isfinite(result.fun):
        status = MinimizerStatus.INVALID_COST_FUNCTION
    elif result.success:
        status = MinimizerStatus.SUCCESS
    elif result.nit >= max_local:
        status = MinimizerStatus.MAX_ITERATIONS_REACHED
    elif last_grad_norm[0] <= convergence_criterion:
        status = MinimizerStatus.SUCCESS
    else:
        status = MinimizerStatus.FAILED

    logs.log(f"Final cost function = {result.fun:.6g} after {result.nit} "
             f"iterations, {n_eval[0]} evaluations, {wall:.1f} s "
             f"({wall / max(result.nit, 1):.3f} s/iter)")
    logs.log(timer.report())
    if status == MinimizerStatus.SUCCESS and checkpoint_file:
        _remove_checkpoint(checkpoint_file)
    return SolveResult(
        status=status, cost=float(result.fun),
        n_iterations=int(result.nit) + it_offset,
        n_evaluations=n_eval[0], gradient_norm=float(last_grad_norm[0]),
        wall_time=wall,
        seconds_per_iteration=wall / max(int(result.nit), 1))
