"""Light spectrum: rendering, random wavelength sampling, color metrics.

Counterpart of ``optrace_tpu/spectrum/light_spectrum.py``:
``random_wavelengths(gen, N)`` takes an explicit ``torch.Generator`` and
samples on the generator's device. The colour metrics (``xyz``, ``color``,
dominant/complementary wavelength) arrive with the colour-conversion slice.
"""

import math

import numpy as np
import torch
import scipy.special

from .spectrum import Spectrum
from .. import color
from ..ops import sampling
from ..utils.property_checker import PropertyChecker as pc
from ..utils.global_options import global_options as go


class LightSpectrum(Spectrum):

    spectrum_types: list = [*Spectrum.spectrum_types, "Blackbody", "Histogram"]

    def __init__(self, spectrum_type: str = "Blackbody", T: float = 5500, **sargs) -> None:
        self.T = T
        line_spec = spectrum_type in ["Monochromatic", "Lines"]
        unit = "W" if line_spec else "W/nm"
        quantity = "Spectral Power" if line_spec else "Spectral Power Density"
        super().__init__(spectrum_type, unit=unit, quantity=quantity, **sargs)

    # ------------------------------------------------------------------
    @staticmethod
    def render(wl, w, **kwargs) -> "LightSpectrum":
        """Render a Histogram LightSpectrum from wavelength/weight arrays
        (reference light_spectrum.py:40-79: ≥51 odd bin count scaling √N,
        values scaled to W/nm)."""
        wl = np.asarray(wl)
        w = np.asarray(w)
        spec = LightSpectrum("Histogram", **kwargs)

        N = max(51, math.sqrt(np.count_nonzero(w)) / 2)
        N = 1 + 2 * (int(N) // 2)

        if not wl.shape[0]:
            spec._wls = np.asarray(color.wavelengths(N + 1))
            spec._vals = np.zeros(N, dtype=np.float64)
        else:
            wl0, wl1 = wl.min(), wl.max()
            if abs(wl0 - wl1) < 1:
                wl0, wl1 = max(wl0 - 1, go.wavelength_range[0]), min(wl0 + 1, go.wavelength_range[1])
            vals, wls = np.histogram(wl, bins=N, weights=w, range=[wl0, wl1])
            spec._vals = vals / (wls[1] - wls[0])
            spec._wls = wls
        return spec

    # ------------------------------------------------------------------
    def random_wavelengths(self, gen: torch.Generator, N: int):
        """Sample N wavelengths (f32 tensor on the generator's device)
        following the spectral distribution."""
        st = self.spectrum_type

        if st == "Monochromatic":
            return torch.full((N,), self.wl, dtype=torch.float32, device=gen.device)

        if st in ("Constant", "Rectangle"):
            wl0 = go.wavelength_range[0] if st == "Constant" else self.wl0
            wl1 = go.wavelength_range[1] if st == "Constant" else self.wl1
            return sampling.stratified_interval_sampling(gen, N, wl0, wl1)

        if st == "Lines":
            pc.check_type("LightSpectrum.lines", self.lines, (np.ndarray, list))
            pc.check_type("LightSpectrum.line_vals", self.line_vals, (np.ndarray, list))
            return sampling.inverse_transform_sampling(
                gen, N, self.lines, self.line_vals, kind="discrete")

        if st == "Data":
            pc.check_type("LightSpectrum.wls", self._wls, (np.ndarray, list))
            pc.check_type("LightSpectrum.vals", self._vals, (np.ndarray, list))
            return sampling.inverse_transform_sampling(
                gen, N, self._wls, self._vals)

        if st == "Gaussian":
            # analytic truncated-Gaussian via erf/erfinv over the visible range
            Xl = (1 + scipy.special.erf((go.wavelength_range[0] - self.mu) / (math.sqrt(2) * self.sig))) / 2
            Xr = (1 + scipy.special.erf((go.wavelength_range[1] - self.mu) / (math.sqrt(2) * self.sig))) / 2
            X = sampling.stratified_interval_sampling(gen, N, Xl, Xr)
            return self.mu + math.sqrt(2) * self.sig * torch.special.erfinv(2 * X - 1)

        if st in ("Blackbody", "Function", "Histogram"):
            cnt = 4000 if st == "Blackbody" else 10000
            wlr = color.wavelengths(cnt)
            return sampling.inverse_transform_sampling(gen, N, wlr, self(wlr))

        raise RuntimeError(f"Unhandled spectrum_type '{st}'.")  # pragma: no cover

    # ------------------------------------------------------------------
    def __call__(self, wl):
        is_t = isinstance(wl, torch.Tensor)
        if self.spectrum_type == "Blackbody":
            return self.val * color.normalized_blackbody(wl, T=self.T)

        if self.spectrum_type == "Histogram":
            pc.check_type("wls", self._wls, np.ndarray)
            pc.check_type("vals", self._vals, np.ndarray)
            assert len(self._wls) == len(self._vals) + 1
            if is_t:
                wls = torch.as_tensor(self._wls, dtype=wl.dtype, device=wl.device)
                vals = torch.as_tensor(self._vals, dtype=wl.dtype, device=wl.device)
                ind = torch.searchsorted(wls, wl, right=True)
                ins = (ind > 0) & (ind < wls.shape[0])
                ind_c = torch.clamp(ind - 1, 0, vals.shape[0] - 1)
                return torch.where(ins, vals[ind_c], 0.0)
            wl_ = np.asarray(wl)
            ind = np.searchsorted(self._wls, wl_, side="right")
            ins = (ind > 0) & (ind < self._wls.shape[0])
            ind_c = np.clip(ind - 1, 0, self._vals.shape[0] - 1)
            return np.where(ins, self._vals[ind_c], 0.0)

        return super().__call__(wl)

    # ------------------------------------------------------------------
    def centroid_wavelength(self) -> float:
        """Power-weighted average wavelength."""
        st = self.spectrum_type
        if st == "Monochromatic":
            return float(self.wl)
        if st == "Lines":
            lam, s = np.asarray(self.lines), np.asarray(self.line_vals)
            return float(np.sum(s * lam) / np.sum(s))
        if st == "Rectangle":
            return float((self.wl0 + self.wl1) / 2)
        if st == "Constant":
            return float(np.mean(go.wavelength_range))
        wl = np.asarray(color.wavelengths(100000))
        s = np.asarray(self(wl))
        if not np.any(s > 0):
            return float(np.mean(go.wavelength_range))
        return float(np.trapezoid(wl * s) / np.trapezoid(s))

    def peak(self) -> float:
        st = self.spectrum_type
        if st in ("Monochromatic", "Gaussian", "Rectangle", "Constant", "Blackbody"):
            return float(self.val)
        if st == "Lines":
            return float(np.asarray(self.line_vals).max())
        if st in ("Histogram", "Data"):
            return float(np.asarray(self._vals).max())
        wl = color.wavelengths(100000)
        return float(np.max(self(wl)))

    def peak_wavelength(self) -> float:
        st = self.spectrum_type
        if st == "Monochromatic":
            return float(self.wl)
        if st == "Lines":
            return float(np.asarray(self.lines)[np.argmax(np.asarray(self.line_vals))])
        if st == "Rectangle":
            return float(self.wl0)
        if st == "Constant":
            return float(go.wavelength_range[0])
        if st == "Gaussian":
            return float(self.mu)
        wl = np.asarray(color.wavelengths(100000))
        return float(wl[int(np.argmax(np.asarray(self(wl))))])

    def fwhm(self) -> float:
        """Full width at half maximum around the highest peak."""
        st = self.spectrum_type
        if st in ("Monochromatic", "Lines"):
            return 0.0
        if st == "Rectangle":
            return float(self.wl1 - self.wl0)
        if st == "Constant":
            return float(go.wavelength_range[1] - go.wavelength_range[0])
        wl = np.asarray(color.wavelengths(100000))
        spec = np.asarray(self(wl))
        ind = int(np.argmax(spec))
        half = 0.5 * spec[ind]
        br = spec[ind:] < half
        indr = ind + int(np.argmax(br)) if np.any(br) else spec.shape[0] - 1
        bl = np.flip(spec[:ind]) < half
        indl = ind - int(np.argmax(bl)) if np.any(bl) else 0
        return float(wl[indr] - wl[indl])

    def _power(self, sensitivity) -> float:
        st = self.spectrum_type
        if st == "Monochromatic":
            return float(sensitivity(np.asarray(self.wl)) * self.val)
        if st == "Lines":
            return float(np.sum(sensitivity(np.asarray(self.lines)) * np.asarray(self.line_vals)))
        if st == "Histogram":
            dl = self._wls[1] - self._wls[0]
            wl2 = self._wls[:-1] + dl / 2
            return float(np.sum(sensitivity(np.asarray(wl2)) * np.asarray(self._vals)) * dl)
        wl = color.wavelengths(100000)
        return float(np.trapezoid(sensitivity(wl) * self(wl)) * (wl[1] - wl[0]))

    def power(self) -> float:
        """Radiant power in W."""
        return self._power(lambda x: np.ones_like(x))

    def luminous_power(self) -> float:
        """Luminous power in lm (683 lm/W · ȳ weighting)."""
        return self._power(lambda x: 683.0 * color.y_observer(x))

    # ------------------------------------------------------------------
    def __setattr__(self, key, val) -> None:
        if key == "val" and isinstance(val, (int, float)):
            pc.check_above(key, val, 0)
        if key == "T":
            pc.check_type(key, val, (int, float))
            val = float(val)
            pc.check_above(key, val, 0)
        if key == "_vals" and val is not None and self.spectrum_type != "Histogram":
            vals = np.asarray(val, dtype=np.float64)
            pc.check_finite(key, vals)
            if np.any(vals < 0):
                raise ValueError("Values below zero in LightSpectrum.")
            if not np.any(vals > 0):
                raise ValueError("LightSpectrum can't be constantly zero.")
            super(Spectrum, self).__setattr__(key, vals)
            return
        super().__setattr__(key, val)
