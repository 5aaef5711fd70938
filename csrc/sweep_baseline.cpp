// Native OpenMP candidate-sweep cost kernel — the measured CPU baseline.
//
// Implements the identical computation to the framework's LW candidate
// sweep (ecckd_tpu/partition/cost_kernel.py CandidateCostLw with the
// "transmission" averaging method) the way the reference ecCKD executes
// it: one OpenMP task per candidate interval, each running a fitted-od
// computation plus a memory-lean broadband two-stream over its own
// wavenumber slice (reference CkdEquipartition::calc_error under
// Equipartition::calc_error_all's `#pragma omp parallel for
// schedule(dynamic)`, equipartition.h:100-104 / find_g_points.cpp:206-426
// — algorithm re-implemented here, no code copied).
//
// Per-sweep work is O(nwav * nlay) when the candidate intervals tile the
// band, so throughput in wavenumber-bins*layers/s is directly comparable
// with the device kernel's number in bench.py.
//
// Numerics: float32 state with float64 broadband accumulators, matching
// the device kernel's f32 compute / stable reductions.

#include <cmath>
#include <cstdint>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr float kDiffusivity = 1.66f;          // LW_DIFFUSIVITY
constexpr float kThresholdEmissivity = 1.0e-5f; // THRESHOLD_EMISSIVITY
constexpr double kHrWeight = 86400.0;           // HR_WEIGHT (K/s -> K/day)
constexpr double kAccelGravity = 9.80665;
constexpr double kSpecificHeatAir = 1004.0;
constexpr float kTransClampF32 = 1.0f - 1.0e-6f; // f32 transmission clamp

}  // namespace

extern "C" {

// Evaluate the LW candidate cost of `nseg` rank intervals.
//
// Layout: planck_hl (nlay+1, nwav) row-major; bg_od/metric/hr (nlay, nwav);
// layer_weight (nlay); pressure_hl (nlay+1, float64);
// surf_emissivity/surf_planck/flux_dn_surf/flux_up_toa (nwav);
// i1/i2 (nseg) inclusive rank bounds; costs_out (nseg).
// Returns the number of threads used (<=0 on error).
int sweep_lw_cost_transmission(
    int nlay, int nwav, int nseg,
    const float* layer_weight,
    const double* pressure_hl,
    const float* surf_emissivity,
    const float* surf_planck,
    const float* flux_dn_surf,
    const float* flux_up_toa,
    const float* planck_hl,
    const float* bg_od,
    const float* metric,
    const float* hr,
    const int32_t* i1,
    const int32_t* i2,
    float flux_weight,
    float* costs_out) {
  if (nlay <= 0 || nwav <= 0 || nseg <= 0) return 0;
  const int nhl = nlay + 1;
  int nthreads = 1;

#pragma omp parallel
  {
#ifdef _OPENMP
#pragma omp single
    nthreads = omp_get_num_threads();
#endif
    // Per-thread scratch: broadband flux profiles + fitted od per layer.
    std::vector<double> flux_dn(nhl), flux_up(nhl);
    std::vector<float> od_fit(nlay);

#pragma omp for schedule(dynamic)
    for (int c = 0; c < nseg; ++c) {
      const int a = i1[c];
      const int b = i2[c];  // inclusive
      if (a < 0 || b >= nwav || b < a) {
        costs_out[c] = -1.0f;
        continue;
      }

      // 1. Fitted grey od per layer, "transmission" averaging
      //    (ops/average.py fit_optical_depth_lw): Planck-weighted mean of
      //    the metric (1 - exp(-D od)), clamped, mapped back through
      //    -log1p(-mean)/D. Weights are the layer-base Planck values.
      for (int l = 0; l < nlay; ++l) {
        const float* w = planck_hl + (l + 1) * (size_t)nwav;
        const float* m = metric + l * (size_t)nwav;
        double num = 0.0, den = 0.0;
        for (int j = a; j <= b; ++j) {
          num += (double)m[j] * (double)w[j];
          den += (double)w[j];
        }
        float mean = (float)(num / den);
        if (mean > kTransClampF32) mean = kTransClampF32;
        od_fit[l] = std::fabs(-std::log1p(-mean) / kDiffusivity);
      }

      // 2. Memory-lean broadband two-stream over the slice
      //    (ops/rt_lw.py rt_lw_bb semantics; reference
      //    radiative_transfer_lw_bb shape). Spectral recurrence per
      //    wavenumber, broadband sums accumulated in double.
      for (int l = 0; l < nhl; ++l) {
        flux_dn[l] = 0.0;
        flux_up[l] = 0.0;
      }
      double fd_surf_true = 0.0, fu_toa_true = 0.0;
      for (int j = a; j <= b; ++j) {
        // downwelling sweep
        float flux = 0.0f;
        float surf_flux_spec;
        for (int l = 0; l < nlay; ++l) {
          const float od = bg_od[l * (size_t)nwav + j] + od_fit[l];
          const float emis = -std::expm1(-kDiffusivity * od);
          const float e = emis > kThresholdEmissivity
                              ? emis : kThresholdEmissivity;
          const float o = od > kThresholdEmissivity / kDiffusivity
                              ? od : kThresholdEmissivity / kDiffusivity;
          float factor = 1.0f - (1.0f / kDiffusivity) * e / o;
          if (factor < 0.5f * kThresholdEmissivity)
            factor = 0.5f * kThresholdEmissivity;
          const float trans = 1.0f - emis;
          const float p_top = planck_hl[l * (size_t)nwav + j];
          const float p_base = planck_hl[(l + 1) * (size_t)nwav + j];
          flux = flux * trans + p_top * (1.0f - trans - factor)
                 + p_base * factor;
          flux_dn[l + 1] += flux;
        }
        surf_flux_spec = flux;

        // surface reflection + emission, then upwelling sweep
        const float se = surf_emissivity[j];
        float uflux = surf_planck[j] * se + (1.0f - se) * surf_flux_spec;
        flux_up[nlay] += uflux;
        for (int l = nlay - 1; l >= 0; --l) {
          const float od = bg_od[l * (size_t)nwav + j] + od_fit[l];
          const float emis = -std::expm1(-kDiffusivity * od);
          const float e = emis > kThresholdEmissivity
                              ? emis : kThresholdEmissivity;
          const float o = od > kThresholdEmissivity / kDiffusivity
                              ? od : kThresholdEmissivity / kDiffusivity;
          float factor = 1.0f - (1.0f / kDiffusivity) * e / o;
          if (factor < 0.5f * kThresholdEmissivity)
            factor = 0.5f * kThresholdEmissivity;
          const float trans = 1.0f - emis;
          const float p_top = planck_hl[l * (size_t)nwav + j];
          const float p_base = planck_hl[(l + 1) * (size_t)nwav + j];
          uflux = uflux * trans + p_base * (1.0f - trans - factor)
                  + p_top * factor;
          flux_up[l] += uflux;
        }
        fd_surf_true += flux_dn_surf[j];
        fu_toa_true += flux_up_toa[j];
      }

      // 3. Cost: layer-weighted squared heating-rate error (K/day) plus
      //    flux-weighted boundary errors (cost_kernel.py
      //    _candidate_cost_from_fluxes).
      double hr_cost = 0.0;
      for (int l = 0; l < nlay; ++l) {
        double hr_true = 0.0;
        const float* h = hr + l * (size_t)nwav;
        for (int j = a; j <= b; ++j) hr_true += h[j];
        const double conv = -(kAccelGravity / kSpecificHeatAir)
                            / (pressure_hl[l + 1] - pressure_hl[l]);
        const double net_diff = (flux_dn[l + 1] - flux_dn[l])
                                - (flux_up[l + 1] - flux_up[l]);
        const double err = conv * net_diff - hr_true;
        hr_cost += (double)layer_weight[l] * err * err;
      }
      const double dn_err = flux_dn[nlay] - fd_surf_true;
      const double up_err = flux_up[0] - fu_toa_true;
      costs_out[c] = (float)std::sqrt(
          kHrWeight * kHrWeight * hr_cost
          + (double)flux_weight * (dn_err * dn_err + up_err * up_err));
    }
  }
  return nthreads;
}

}  // extern "C"
