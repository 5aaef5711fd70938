"""G-point bookkeeping for a single gas, gas overlap, and repartitioning.

Equivalents of src/ecckd/single_gas_data.{h,cpp}: the
``SingleGasData`` record used by find_g_points (distinct from the CkdModel
gas record), the hypercube-partition gas overlap of Hogan (2010)
(single_gas_data.cpp:23-124 — pure integer logic, ported faithfully), and
error-density-based repartitioning (single_gas_data.cpp:129-284).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from .. import logs


@dataclasses.dataclass
class SingleGasData:
    """Per-gas g-point properties (ref single_gas_data.h:31-116)."""
    molecule: str
    n_g_points: np.ndarray         # (nband,) number of g-points per band
    band_number: np.ndarray        # (ng,) band of each g-point
    rank1: np.ndarray              # (ng,) first sorted-wavenumber index
    rank2: np.ndarray              # (ng,) last sorted-wavenumber index
    error: np.ndarray              # (ng,) RMS heating-rate error per g-point
    sorting_variable: np.ndarray   # (ng,) median sorting variable per g-point
    g_point: Optional[np.ndarray] = None  # (nwav,) g-point of each wavenumber
    # Filled by overlap_g_points:
    g_min: Optional[np.ndarray] = None    # (ng_merged,)
    g_max: Optional[np.ndarray] = None    # (ng_merged,)

    @property
    def Molecule(self) -> str:
        return self.molecule.upper()

    def nbands(self) -> int:
        return len(self.n_g_points)

    def ng(self) -> int:
        return len(self.rank1)

    def store_g_points(self, rank: np.ndarray):
        """Per-wavenumber g-point map from rank ranges
        (ref single_gas_data.h:59-66)."""
        self.g_point = np.full(rank.max() + 1, -1, np.int32)
        for ig in range(self.ng()):
            self.g_point[(rank >= self.rank1[ig])
                         & (rank <= self.rank2[ig])] = ig

    def print(self):
        logs.log(f"Single-gas data for {self.Molecule}:")
        logs.log(f"  number of g-points in each band     = {self.n_g_points}")
        logs.log(f"  band associated with each g-point   = {self.band_number}")
        logs.log(f"  wavenumber rank lower bound         = {self.rank1}")
        logs.log(f"  wavenumber rank upper bound         = {self.rank2}")
        logs.log(f"  heating-rate error for each g-point = {self.error}")
        logs.log(f"  sorting variable for each g-point   = "
                 f"{self.sorting_variable}")


def overlap_g_points(gas_data: List[SingleGasData]) -> np.ndarray:
    """Hypercube-partition overlap of per-gas g-points (Hogan 2010).

    Fills g_min/g_max of each gas in place and returns the band number of
    each merged g-point.  Ref single_gas_data.cpp:23-124: per band, the
    number of merged points is 1 - ngas + sum(ng_i); each successive merged
    point advances the gas whose next g-point has the smallest sorting
    variable.
    """
    ngas = len(gas_data)
    nband = gas_data[0].nbands()
    ng_band = np.empty(nband, np.int64)
    for iband in range(nband):
        ng_band[iband] = 1 - ngas + sum(int(g.n_g_points[iband])
                                        for g in gas_data)
    ng = int(ng_band.sum())

    band_number = np.empty(ng, np.int32)
    ig0 = 0
    for iband in range(nband):
        band_number[ig0:ig0 + ng_band[iband]] = iband
        ig0 += ng_band[iband]

    for g in gas_data:
        g.g_min = np.zeros(ng, np.int32)
        g.g_max = np.zeros(ng, np.int32)

    ig = 0
    ig_gas = np.zeros(ngas, np.int64)
    for iband in range(nband):
        logs.detail(f"Band {iband}")
        ig_gas_start = ig_gas.copy()
        logs.detail(f"  G-point {ig}: intersection of weakest spectral "
                    "interval of each gas")
        for igas in range(ngas):
            gas_data[igas].g_min[ig] = ig_gas_start[igas]
            gas_data[igas].g_max[ig] = ig_gas_start[igas]

        for _ in range(1, int(ng_band[iband])):
            min_sorting_var = 1.0e30
            i_found_gas = -1
            for igas in range(ngas):
                g = gas_data[igas]
                if ig_gas[igas] < (ig_gas_start[igas]
                                   + g.n_g_points[iband] - 1):
                    sv = g.sorting_variable[ig_gas[igas] + 1]
                else:
                    sv = 1.0e30
                if sv < min_sorting_var:
                    min_sorting_var = sv
                    i_found_gas = igas
            if i_found_gas < 0:
                raise RuntimeError("Could not locate next gas to advance")
            ig_gas[i_found_gas] += 1
            ig += 1
            logs.detail(f"  G-point {ig}: major gas "
                        f"{gas_data[i_found_gas].Molecule} "
                        f"({ig_gas[i_found_gas]})")
            for igas in range(ngas):
                if igas == i_found_gas:
                    gas_data[igas].g_min[ig] = ig_gas[igas]
                    gas_data[igas].g_max[ig] = ig_gas[igas]
                else:
                    gas_data[igas].g_min[ig] = ig_gas_start[igas]
                    gas_data[igas].g_max[ig] = ig_gas[igas]

        ig += 1
        ig_gas += 1

    return band_number


def merged_g_point_map(gas_data: List[SingleGasData], ng: int,
                       nwav: int) -> np.ndarray:
    """Per-wavenumber merged g-point map (ref find_g_points.cpp:1459-1481).

    A wavenumber belongs to merged g-point ig if every gas's per-wavenumber
    g-point lies within [g_min(ig), g_max(ig)]; later merged points win."""
    g_point = np.full(nwav, -1, np.int32)
    for ig in range(ng):
        is_found = np.ones(nwav, bool)
        for g in gas_data:
            is_found &= ((g.g_point >= g.g_min[ig])
                         & (g.g_point <= g.g_max[ig]))
        if not np.any(is_found):
            logs.warning(f"g point {ig} occupies none of the spectrum")
        g_point[is_found] = ig
    n_unassigned = int(np.sum(g_point == -1))
    if n_unassigned:
        logs.warning(f"{n_unassigned} wavenumbers are not assigned to a "
                     "g point")
    return g_point


def repartition_g_points(src: SingleGasData, weight: np.ndarray,
                         rank: np.ndarray,
                         n_g_points: Optional[np.ndarray] = None
                         ) -> SingleGasData:
    """Re-split g-points by a piecewise-linear error-density model
    (ref single_gas_data.cpp:129-284)."""
    n_g_dest = src.n_g_points.copy() if n_g_points is None \
        else np.asarray(n_g_points)
    nband = src.nbands()
    ng = int(n_g_dest.sum())

    band_number = np.empty(ng, np.int32)
    igstart = 0
    for iband in range(nband):
        band_number[igstart:igstart + n_g_dest[iband]] = iband
        igstart += n_g_dest[iband]

    rank1 = np.zeros(ng, np.int64)
    rank2 = np.zeros(ng, np.int64)

    weight_sorted = np.empty_like(weight)
    weight_sorted[rank] = weight
    cum_error_density = np.zeros(len(rank))

    ioldg = 0
    ig = 0
    for iband in range(nband):
        nsrc = int(src.n_g_points[iband])
        ioldg = int(src.n_g_points[:iband].sum())
        rank1[ig] = src.rank1[ioldg]

        error_density = np.empty(nsrc)
        sum_weight = np.empty(nsrc)
        for j in range(nsrc):
            sel = ((rank >= src.rank1[ioldg + j])
                   & (rank <= src.rank2[ioldg + j]))
            sum_weight[j] = weight[sel].sum()
            error_density[j] = src.error[ioldg + j] / sum_weight[j]

        ed1 = np.empty(nsrc)
        ed2 = np.empty(nsrc)
        ed1[-1] = error_density[-1]
        ed2[-1] = error_density[-1]
        for j in range(nsrc - 1):
            ideal1 = 0.0 if j == 0 else 0.5 * (error_density[j]
                                               + error_density[j - 1])
            ideal2 = 0.5 * (error_density[j] + error_density[j + 1])
            if ((ideal1 < error_density[j])
                    == (error_density[j] < ideal2)):
                diff = np.copysign(
                    min(abs(error_density[j] - ideal1),
                        abs(ideal2 - error_density[j])),
                    error_density[j] - ideal1)
                ed1[j] = error_density[j] - diff
                ed2[j] = error_density[j] + diff
            else:
                ed1[j] = error_density[j]
                ed2[j] = error_density[j]

        sum_error_density = 0.0
        for j in range(nsrc):
            jg = ioldg + j
            x = 0.0
            for irank in range(int(src.rank1[jg]), int(src.rank2[jg]) + 1):
                x += weight_sorted[irank] / sum_weight[j]
                local = (1.0 - x) * ed1[j] + x * ed2[j]
                sum_error_density += weight_sorted[irank] * local
                cum_error_density[irank] = sum_error_density

        irank = int(rank1[ig])
        iglocal = 0
        ndest = int(n_g_dest[iband])
        while iglocal < ndest - 1:
            target = (iglocal + 1) * sum_error_density / ndest
            if nsrc == ndest:
                damper = 0.8
                target = (damper * src.error[:iglocal + 1].sum()
                          + (1.0 - damper) * target)
            while cum_error_density[irank] < target:
                irank += 1
            rank2[ig] = irank - 1
            ig += 1
            iglocal += 1
            rank1[ig] = irank
        rank2[ig] = src.rank2[int(src.n_g_points[:iband + 1].sum()) - 1]
        ig += 1

    dest = SingleGasData(
        molecule=src.molecule, n_g_points=n_g_dest,
        band_number=band_number, rank1=rank1, rank2=rank2,
        error=np.full(ng, -1.0), sorting_variable=np.full(ng, -1.0))
    dest.store_g_points(rank)
    return dest
