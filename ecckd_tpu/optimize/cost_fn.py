"""Training cost function for LUT optimization.

Equivalent of calc_cost_function_and_gradient + the Adept tape
(src/ecckd/solve_adept.cpp:23-203): one pure function of the log-LUT pytree,
differentiated with ``jax.value_and_grad`` and jit-compiled.  Profiles within
a scene are vmapped; for multi-chip runs the profile axis is sharded across
the mesh and XLA inserts the psum over LUT gradients automatically (the LUTs
are replicated).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np

from ..constants import MOLES_PER_PA
from ..models.gas_optics import ConcDependence, calc_optical_depth

# Sentinel for log of exactly-zero coefficients (ref solve_adept.cpp:21)
MIN_X = -1.0e20


class SceneArrays(NamedTuple):
    """Device arrays of one training scene (a pytree)."""
    pressure_hl: Any          # (ncol, nlev+1)
    temperature_fl: Any       # (ncol, nlay)
    vmr_fl: Any               # (ncol, ngas_lbl, nlay)
    flux_dn_true: Any         # (ncol, nlev+1, nband)
    flux_up_true: Any
    hr_true: Any              # (ncol, nlay, nband)
    layer_weight: Any         # (ncol, nlay)
    planck_hl: Any            # LW: (ncol, nlev+1, ng); SW: None
    surf_planck: Any          # LW: (ncol, ng)
    surf_emissivity_g: Any    # LW: (ncol, ng)
    mu0: Any                  # SW: (ncol,)
    ssi_g: Any                # SW: (ng,) tsi-scaled solar irradiance
    albedo_g: Any             # SW: (ng,)
    spectral_flux_dn_surf: Any   # (ncol, ng) or None
    spectral_flux_up_toa: Any
    relative_flux_dn: Any     # (ncol, nlev+1, ng) or None
    relative_flux_up: Any


@dataclasses.dataclass
class SceneMeta:
    """Static (non-traced) per-scene metadata."""
    is_sw: bool
    gas_mapping: np.ndarray       # CKD gas index -> LBL vmr index
    band_onehot: np.ndarray       # (ng, nband)
    with_upwelling: bool = True   # SW only
    spectral_boundary_weights: Optional[np.ndarray] = None   # SW (ng,)
    profile_weight: Optional[np.ndarray] = None   # (ncol,), 0 = padding


def _exp_state(log_table):
    """Map log-space state to coefficients, holding zeros at zero."""
    import jax.numpy as jnp
    return jnp.where(log_table > MIN_X, jnp.exp(log_table), 0.0)


def build_scene(model, lbl, pressure_weight_power=0.5,
                erythemal_weight=0.0,
                relative_fluxes=None) -> (SceneArrays, SceneMeta):
    """Prepare a training scene's device arrays + static metadata from a
    CkdModel and an LblFluxes (host side, done once)."""
    import jax.numpy as jnp
    from ..models.gas_optics import temperature_fl_from_hl

    ng = model.ng
    nspec = lbl.nspec()
    iband = lbl.iband_per_g
    if iband is None:
        iband = np.arange(nspec)
    nband = int(iband.max()) + 1
    band_onehot = (iband[:, None] == np.arange(nband)[None, :]
                   ).astype(np.float64)

    t_fl = np.asarray(temperature_fl_from_hl(lbl.pressure_hl,
                                             lbl.temperature_hl))

    # Layer weights: pressure-power weighting per profile
    # (ref solve_adept.cpp:132-143)
    p = lbl.pressure_hl
    if pressure_weight_power == 1.0:
        lw = np.diff(p, axis=1)
    else:
        lw = (p[:, 1:] ** pressure_weight_power
              - p[:, :-1] ** pressure_weight_power)
    lw = lw / lw.sum(axis=1, keepdims=True)

    planck_hl = surf_planck = surf_emis_g = None
    mu0 = ssi_g = albedo_g = None
    with_upwelling = True
    sbw = None
    if not lbl.is_sw:
        planck_hl = np.asarray(lbl.planck_hl)
        surf_planck = np.asarray(lbl.surf_planck)
        surf_emis_g = lbl.surf_emissivity[:, iband]
    else:
        mu0 = lbl.mu0
        tsi_scaling = lbl.tsi / model.solar_irradiance.sum()
        ssi_g = tsi_scaling * model.solar_irradiance
        albedo_g = lbl.effective_spectral_albedo[iband]
        with_upwelling = bool(np.any(lbl.effective_spectral_albedo > 0.0))
        if erythemal_weight > 0.0 and lbl.erythemal_spectrum is not None:
            sbw = erythemal_weight * lbl.erythemal_spectrum

    rel_dn = rel_up = None
    if relative_fluxes is not None:
        rel_dn, rel_up = relative_fluxes

    arrays = SceneArrays(
        pressure_hl=jnp.asarray(lbl.pressure_hl),
        temperature_fl=jnp.asarray(t_fl),
        vmr_fl=jnp.asarray(lbl.vmr_fl),
        flux_dn_true=jnp.asarray(lbl.spectral_flux_dn),
        flux_up_true=jnp.asarray(lbl.spectral_flux_up),
        hr_true=jnp.asarray(lbl.spectral_heating_rate),
        layer_weight=jnp.asarray(lw),
        planck_hl=None if planck_hl is None else jnp.asarray(planck_hl),
        surf_planck=None if surf_planck is None else jnp.asarray(surf_planck),
        surf_emissivity_g=(None if surf_emis_g is None
                           else jnp.asarray(surf_emis_g)),
        mu0=None if mu0 is None else jnp.asarray(mu0),
        ssi_g=None if ssi_g is None else jnp.asarray(ssi_g),
        albedo_g=None if albedo_g is None else jnp.asarray(albedo_g),
        spectral_flux_dn_surf=(None if lbl.spectral_flux_dn_surf is None
                               else jnp.asarray(lbl.spectral_flux_dn_surf)),
        spectral_flux_up_toa=(None if lbl.spectral_flux_up_toa is None
                              else jnp.asarray(lbl.spectral_flux_up_toa)),
        relative_flux_dn=None if rel_dn is None else jnp.asarray(rel_dn),
        relative_flux_up=None if rel_up is None else jnp.asarray(rel_up),
    )
    meta = SceneMeta(is_sw=lbl.is_sw, gas_mapping=lbl.gas_mapping,
                     band_onehot=band_onehot,
                     with_upwelling=with_upwelling,
                     spectral_boundary_weights=sbw)
    return arrays, meta


def make_total_od_fn(model, meta: SceneMeta):
    """Pure function: (state_tree, scene) -> od (ncol, nlay, ng).

    Replaces calc_total_optical_depth (solve_adept.cpp:23-69): sums CKD od
    over gases (traced values for active gases, constants otherwise) plus
    Rayleigh (SW).
    """
    import jax.numpy as jnp
    from ..models.gas_optics import rayleigh_optical_depth

    log_pressure = jnp.asarray(model.log_pressure)
    temperature_lut = jnp.asarray(model.temperature)
    gas_info = []
    for igas, g in enumerate(model.single_gas_data):
        gm = int(meta.gas_mapping[igas])
        if gm < 0 and g.conc_dependence != ConcDependence.NONE:
            continue      # gas not present in LBL file
        gas_info.append((igas, g, gm))

    def total_od(tree, scene: SceneArrays):
        od = 0.0
        if meta.is_sw:
            if model.rayleigh_is_active and "rayleigh" in tree:
                coeff = _exp_state(tree["rayleigh"])
            else:
                coeff = jnp.asarray(model.rayleigh_molar_scat)
            od = od + rayleigh_optical_depth(scene.pressure_hl, coeff)
        for igas, g, gm in gas_info:
            if g.is_active:
                table = _exp_state(tree[g.molecule])
            else:
                table = jnp.asarray(g.molar_abs)
            vmr = scene.vmr_fl[:, gm, :] if gm >= 0 else None
            od = od + calc_optical_depth(
                g.conc_dependence, table, scene.pressure_hl,
                scene.temperature_fl, log_pressure, temperature_lut,
                vmr_fl=vmr, lut_vmr=g.vmr, reference_vmr=g.reference_vmr,
                logarithmic_interpolation=model.logarithmic_interpolation)
        return od

    return total_od


def make_cost_fn(model, scenes, weights, negative_od_penalty=1.0e4):
    """Build the full training-cost function of the log-LUT pytree.

    Args:
      model: CkdModel with active gases flagged.
      scenes: list of (SceneArrays, SceneMeta).
      weights: ops.cost.CostWeights.

    Returns:
      cost(tree) -> scalar (jit/grad-compatible).
    """
    import jax
    import jax.numpy as jnp
    from ..ops.cost import cost_ckd_lw, cost_ckd_sw

    od_fns = [make_total_od_fn(model, meta) for _, meta in scenes]

    def cost(tree):
        total = 0.0
        for (scene, meta), od_fn in zip(scenes, od_fns):
            od = od_fn(tree, scene)
            # Negative-od quadratic penalty (ref solve_adept.cpp:107-116)
            neg = jnp.minimum(od, 0.0)
            total = total + negative_od_penalty * jnp.sum(neg * neg)
            od = jnp.maximum(od, 0.0)

            band_onehot = jnp.asarray(meta.band_onehot)
            if not meta.is_sw:
                def one_profile(p_hl, planck_hl, emis_g, s_planck, od1,
                                fdn, fup, hr, lw, sdn, sup, rdn, rup):
                    return cost_ckd_lw(
                        p_hl, planck_hl, emis_g, s_planck, od1, fdn, fup,
                        hr, lw, band_onehot, weights,
                        spectral_flux_dn_surf=sdn,
                        spectral_flux_up_toa=sup,
                        relative_flux_dn=rdn, relative_flux_up=rup)

                args = [scene.pressure_hl, scene.planck_hl,
                        scene.surf_emissivity_g, scene.surf_planck, od,
                        scene.flux_dn_true, scene.flux_up_true,
                        scene.hr_true, scene.layer_weight,
                        scene.spectral_flux_dn_surf,
                        scene.spectral_flux_up_toa,
                        scene.relative_flux_dn, scene.relative_flux_up]
            else:
                sbw = (None if meta.spectral_boundary_weights is None
                       else jnp.asarray(meta.spectral_boundary_weights))

                def one_profile(mu0, p_hl, od1, fdn, fup, hr, lw,
                                sdn, sup, rdn, rup):
                    return cost_ckd_sw(
                        mu0, p_hl, scene.ssi_g, scene.albedo_g, od1,
                        fdn, fup, hr, lw, band_onehot, weights,
                        with_upwelling=meta.with_upwelling,
                        spectral_boundary_weights=sbw,
                        spectral_flux_dn_surf=sdn,
                        relative_flux_dn=rdn, relative_flux_up=rup)

                args = [scene.mu0, scene.pressure_hl, od,
                        scene.flux_dn_true, scene.flux_up_true,
                        scene.hr_true, scene.layer_weight,
                        scene.spectral_flux_dn_surf,
                        scene.spectral_flux_up_toa,
                        scene.relative_flux_dn, scene.relative_flux_up]

            # vmap over profiles; None args stay None via in_axes trick
            in_axes = [None if a is None else 0 for a in args]
            safe_args = [0.0 if a is None else a for a in args]
            in_axes = [ax if a is not None else None
                       for ax, a in zip(in_axes, args)]

            def wrapper(*a):
                real = [None if orig is None else given
                        for orig, given in zip(args, a)]
                return one_profile(*real)

            per_profile = jax.vmap(wrapper, in_axes=tuple(in_axes))(
                *safe_args)
            if meta.profile_weight is not None:
                # Zero-weight profiles are device-padding copies
                # (_shard_scene_profiles); they run but contribute nothing.
                per_profile = per_profile * jnp.asarray(meta.profile_weight)
            total = total + jnp.sum(per_profile)
        return total

    return cost


def make_prior_fn(model):
    """Prior cost of the log-state delta tree (ref CkdOptimizable,
    solve_adept.cpp:262-283), differentiable in the tree."""
    import jax
    import jax.numpy as jnp

    gases = [(g.molecule, jnp.asarray(g.inv_background_shape),
              jnp.asarray(1.0 / g.background_error ** 2))
             for g in model.single_gas_data
             if g.is_active and g.inv_background_shape is not None]
    rayleigh_inv = (jnp.asarray(model.rayleigh_inv_background)
                    if model.rayleigh_is_active
                    and model.rayleigh_inv_background is not None else None)

    def prior(tree, prior_tree):
        cost = 0.0
        for mol, shape_mat, inv_var in gases:
            # Deltas at sentinel positions do not contribute
            delta = jnp.where(
                jnp.asarray(prior_tree[mol]) > MIN_X,
                tree[mol] - jnp.asarray(prior_tree[mol]), 0.0)
            ng = delta.shape[-1]
            d2 = jnp.reshape(delta, (-1, ng))
            grad = jnp.matmul(shape_mat, d2,
                              precision=jax.lax.Precision.HIGHEST
                              ) * inv_var[None, :]
            cost = cost + 0.5 * jnp.sum(d2 * grad)
        if rayleigh_inv is not None and "rayleigh" in tree:
            delta = jnp.where(
                jnp.asarray(prior_tree["rayleigh"]) > MIN_X,
                tree["rayleigh"] - jnp.asarray(prior_tree["rayleigh"]), 0.0)
            cost = cost + 0.5 * jnp.sum(rayleigh_inv * delta * delta)
        return cost

    return prior
