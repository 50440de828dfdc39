"""Light spectrum: rendering, random wavelength sampling, color metrics.

Counterpart of ``optrace_tpu/spectrum/light_spectrum.py``:
``random_wavelengths(gen, N)`` takes an explicit ``torch.Generator`` and
samples on the generator's device.
"""

import math

import numpy as np
import torch
import scipy.special

from .spectrum import Spectrum
from .. import color
from ..ops import sampling, binning
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
        """Render a Histogram LightSpectrum from wavelengths and weights,
        tensors (binned on their device) or host arrays: an odd bin count
        of at least 51 that grows with √N, values scaled to W/nm, and
        ``_wls``, ``_vals`` as f64 host arrays."""
        wl = torch.as_tensor(np.array(wl) if isinstance(wl, np.ndarray) else wl).to(torch.float64)
        w = torch.as_tensor(np.array(w) if isinstance(w, np.ndarray) else w).to(wl.device, torch.float64)
        spec = LightSpectrum("Histogram", **kwargs)

        N = max(51, math.sqrt(int(torch.count_nonzero(w))) / 2)
        N = 1 + 2 * (int(N) // 2)

        if not wl.shape[0]:
            spec._wls = np.asarray(color.wavelengths(N + 1))
            spec._vals = np.zeros(N, dtype=np.float64)
        else:
            wl0, wl1 = torch.stack([wl.min(), wl.max()]).tolist()
            if abs(wl0 - wl1) < 1:
                wl0, wl1 = max(wl0 - 1, go.wavelength_range[0]), min(wl0 + 1, go.wavelength_range[1])
            wls = np.linspace(wl0, wl1, N + 1)
            vals = binning.histogram_1d(wl, w, N, wl0, wl1).cpu().numpy()
            spec._vals = vals / (wls[1] - wls[0])
            spec._wls = wls
        return spec

    # ------------------------------------------------------------------
    def random_wavelengths(self, gen: torch.Generator, N: int):
        """Sample N wavelengths (f32 tensor on the generator's device)
        following the spectral distribution."""
        return self.wavelength_sampler(gen.device)(gen, N)

    def wavelength_sampler(self, device):
        """``(gen, N) -> N wavelengths`` (f32 on ``device``) following the
        spectral distribution, with every table it needs made on ``device``
        now: a call draws from ``gen`` and copies nothing from the host."""
        st = self.spectrum_type

        if st == "Monochromatic":
            wl = self.wl
            return lambda gen, N: torch.full((N,), wl, dtype=torch.float32, device=gen.device)

        if st in ("Constant", "Rectangle"):
            wl0 = go.wavelength_range[0] if st == "Constant" else self.wl0
            wl1 = go.wavelength_range[1] if st == "Constant" else self.wl1
            return lambda gen, N: sampling.stratified_interval_sampling(gen, N, wl0, wl1)

        if st == "Lines":
            pc.check_type("LightSpectrum.lines", self.lines, (np.ndarray, list))
            pc.check_type("LightSpectrum.line_vals", self.line_vals, (np.ndarray, list))
            return sampling.inverse_transform_sampler(self.lines, self.line_vals, device,
                                                      kind="discrete")

        if st == "Data":
            pc.check_type("LightSpectrum.wls", self._wls, (np.ndarray, list))
            pc.check_type("LightSpectrum.vals", self._vals, (np.ndarray, list))
            return sampling.inverse_transform_sampler(self._wls, self._vals, device)

        if st == "Gaussian":
            # analytic truncated-Gaussian via erf/erfinv over the visible range
            mu, sig = self.mu, self.sig
            Xl = (1 + scipy.special.erf((go.wavelength_range[0] - mu) / (math.sqrt(2) * sig))) / 2
            Xr = (1 + scipy.special.erf((go.wavelength_range[1] - mu) / (math.sqrt(2) * sig))) / 2

            def gaussian(gen, N):
                X = sampling.stratified_interval_sampling(gen, N, Xl, Xr)
                return mu + math.sqrt(2) * sig * torch.special.erfinv(2 * X - 1)
            return gaussian

        if st in ("Blackbody", "Function", "Histogram"):
            cnt = 4000 if st == "Blackbody" else 10000
            wlr = color.wavelengths(cnt)
            return sampling.inverse_transform_sampler(wlr, self(wlr), device)

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
    def xyz(self) -> np.ndarray:
        """XYZ tristimulus of the spectrum."""
        st = self.spectrum_type
        if st == "Monochromatic":
            wl = np.array([self.wl])
            spec = np.array([self.val])
        elif st == "Lines":
            pc.check_type("LightSpectrum.lines", self.lines, (np.ndarray, list))
            pc.check_type("LightSpectrum.line_vals", self.line_vals, (np.ndarray, list))
            wl, spec = self.lines, self.line_vals
        else:
            cnt = 10000 if st in ("Function", "Data", "Histogram") else 4000
            wl = color.wavelengths(cnt)
            spec = self(wl)
        return color.xyz_from_spectrum(wl, spec).numpy()

    def color(self, rendering_intent: str = "Ignore", clip: bool = False,
              L_th: float = 0.0, chroma_scale: float = None):
        """sRGB color of the spectrum."""
        XYZ = self.xyz()[None, None, :]
        RGB = color.xyz_to_srgb(XYZ, rendering_intent=rendering_intent, clip=clip, L_th=L_th,
                                chroma_scale=chroma_scale)[0, 0]
        return float(RGB[0]), float(RGB[1]), float(RGB[2])

    def dominant_wavelength(self) -> float:
        return float(color.dominant_wavelength(self.xyz()))

    def complementary_wavelength(self) -> float:
        return float(color.complementary_wavelength(self.xyz()))

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
