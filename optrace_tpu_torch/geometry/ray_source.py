"""Ray source: emitting geometry + spectrum + divergence + polarization.

Counterpart of ``optrace_tpu/geometry/ray_source.py``: ``create_rays(gen, N,
...)`` makes the rays on the device of the ``torch.Generator`` it is given.

Emitter kinds: Surface (uniform emittance), Point/Line, RGBImage (per-pixel
probability ∝ linear-RGB radiant power, wavelengths from the sRGB primary
spectra matching the pixel colour) and GrayscaleImage (emittance from the
image, user spectrum). Divergence None/Lambertian/Isotropic/Function
(cone or 2D arc); orientation Constant/Converging/Function; polarization
x/y/xy/Constant/Uniform/List/Function with transport onto each ray's
transverse plane.
"""

import math
from typing import Any, Callable

import numpy as np
import torch

from .element import Element
from .surface import Surface, RectangularSurface
from .point import Point
from .line import Line
from ..spectrum.light_spectrum import LightSpectrum
from .. import color
from ..image.rgb_image import RGBImage
from ..image.grayscale_image import GrayscaleImage
from ..ops import sampling
from ..ops.vector import cross as tcross, normalize_safe
from ..utils.property_checker import PropertyChecker as pc


class RaySource(Element):

    divergences: list = ["None", "Lambertian", "Isotropic", "Function"]
    orientations: list = ["Constant", "Converging", "Function"]
    polarizations: list = ["Constant", "Uniform", "List", "Function", "x", "y", "xy"]

    abbr: str = "RS"
    _allow_non_2D: bool = True
    _max_image_px: float = 2e6

    def __init__(self, surface, pos=None,
                 divergence: str = "None", div_angle: float = 0.5,
                 div_2d: bool = False, div_axis_angle: float = 0,
                 div_func: Callable = None, div_args: dict = None,
                 spectrum: LightSpectrum = None, power: float = 1.,
                 s=None, s_sph=None, orientation: str = "Constant",
                 conv_pos=None, or_func: Callable = None, or_args: dict = None,
                 polarization: str = "Uniform", pol_angle: float = 0.,
                 pol_angles=None, pol_probs=None, pol_func: Callable = None,
                 pol_args: dict = None, **kwargs) -> None:
        self._new_lock = False

        if isinstance(surface, (RGBImage, GrayscaleImage)):
            if surface.shape[0] * surface.shape[1] > self._max_image_px:
                raise RuntimeError(f"Image has more than {self._max_image_px:.0f} pixels.")
            surface_ = RectangularSurface(dim=surface.s)
            self._image = surface
            if isinstance(surface, RGBImage):
                sRGBL = color.srgb_to_srgb_linear(surface._data)
                If = color.power_from_srgb_linear(sRGBL).numpy().flatten()
                self._mean_img_color = color.srgb_linear_to_srgb(
                    sRGBL.mean(dim=(0, 1))[None, None, :]).numpy()[0, 0]
            else:
                If = color.srgb_to_srgb_linear(surface.data).numpy().ravel()
                self._mean_img_color = None
            self._pIf = If / If.sum()
        elif isinstance(surface, (Surface, Point, Line)):
            surface_ = surface
            self._image = None
            self._pIf = None
            self._mean_img_color = None
        else:
            raise TypeError(f"a RaySource emits from a Surface, Point, Line, RGBImage or "
                            f"GrayscaleImage, not from {type(surface).__name__}")

        pos = pos if pos is not None else [0, 0, 0]
        super().__init__(surface_, pos, **kwargs)

        self.power = power
        from ..presets.light_spectrum import d65 as d65_spectrum
        self.spectrum = spectrum if spectrum is not None else d65_spectrum

        self.polarization = polarization
        self.pol_angle = pol_angle
        self.pol_func = pol_func
        self.pol_angles = pol_angles
        self.pol_probs = pol_probs
        self.pol_args = pol_args if pol_args is not None else {}

        self.divergence = divergence
        self.div_angle = div_angle
        self.orientation = orientation
        self.conv_pos = conv_pos if conv_pos is not None else [0, 0, 0]
        self.or_func = or_func
        self.or_args = or_args if or_args is not None else {}

        if s_sph is None:
            self.s = s if s is not None else [0, 0, 1]
        else:
            pc.check_type("s_sph", s_sph, (list, np.ndarray))
            theta, phi = np.radians(s_sph[0]), np.radians(s_sph[1])
            self.s = [np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)]

        self.div_axis_angle = div_axis_angle
        self.div_func = div_func
        # (the JAX package's constructor drops div_args, so that its
        # divergence functions fail on an unknown attribute)
        self.div_args = div_args if div_args is not None else {}
        self.div_2d = div_2d
        self._new_lock = True

    # ------------------------------------------------------------------
    def image_pixels(self, u):
        """Flat pixel index (row-major, int64) of an image source for
        uniforms ``u`` in [0, 1): the lower bound of ``u`` in the f32
        cumulative pixel power, clipped to the last pixel. ``u`` decides
        the device."""
        return self._pixel_lookup(u.device)(u)

    def _pixel_lookup(self, device):
        """:meth:`image_pixels` with the cumulative pixel power made on
        ``device`` now."""
        cdf = np.cumsum(self._pIf)
        cdf = torch.as_tensor((cdf / cdf[-1]).astype(np.float32), device=device)
        last = cdf.shape[0] - 1
        return lambda u: torch.clamp(torch.searchsorted(cdf, u, right=False), max=last)

    def image_positions(self, P, rx, ry):
        """Positions (N, 3) inside the pixels ``P`` (flat indices) of an
        image source, from the in-pixel uniforms ``rx, ry`` in [0, 1)."""
        Iy, Ix = self._image.shape[:2]
        PY, PX = torch.div(P, Ix, rounding_mode="floor"), P % Ix
        xs, xe, ys, ye = (float(v) for v in self.surface.extent[:4])
        px = (xe - xs) / Ix * (PX + rx) + xs
        py = (ye - ys) / Iy * (PY + ry) + ys
        return torch.stack([px, py, torch.full_like(px, float(self.pos[2]))], dim=-1)

    def create_rays(self, gen: torch.Generator, N: int, no_pol: bool = False,
                    power: float = None):
        """Generate N rays (p, s, pols, weights, wavelengths) as f32 tensors
        on the device of ``gen``. Every sampling stream draws from ``gen``
        in turn, so the streams are independent."""
        return self.ray_sampler(N, gen.device, no_pol, power)(gen)

    def ray_sampler(self, N: int, device, no_pol: bool = False, power: float = None):
        """``gen -> (p, s, pols, weights, wavelengths)``: :meth:`create_rays`
        of N rays with every table and constant it needs made on ``device``
        now, so that a call draws from ``gen`` and copies nothing from the
        host (a render step builds it once; a CUDA graph can capture it)."""
        f32 = torch.float32
        power = power if power is not None else self.power

        # wavelengths (an RGB image draws them below, from its pixels)
        rgb_image = isinstance(self._image, RGBImage)
        if not rgb_image:
            pc.check_type("RaySource.spectrum", self.spectrum, LightSpectrum)
            wavelength_fn = self.spectrum.wavelength_sampler(device)
        if self._image is not None:
            one_pixel = self._image.shape[0] * self._image.shape[1] == 1
            pixel_fn = None if one_pixel else self._pixel_lookup(device)
            if rgb_image:
                pix = torch.as_tensor(self._image._data.reshape(-1, 3), dtype=f32, device=device)

        # orientations
        if self.orientation == "Constant":
            s_const = torch.as_tensor(self.s, dtype=f32, device=device)
        elif self.orientation == "Converging":
            conv = torch.as_tensor(self.conv_pos, dtype=f32, device=device)
        elif self.orientation == "Function":
            pc.check_callable("RaySource.or_func", self.or_func)
        else:
            raise RuntimeError(f"Unknown orientation '{self.orientation}'.")  # pragma: no cover

        # divergence angles (theta from axis, alpha azimuthal)
        div = self.divergence
        if div == "Function":
            pc.check_callable("RaySource.div_func", self.div_func)
        div_rad = math.radians(self.div_angle)
        div_sin = math.sin(div_rad)
        if self.div_2d:
            # 2D divergence: alpha takes two discrete values
            a0 = math.radians(self.div_axis_angle)
            alpha_fn = sampling.inverse_transform_sampler([a0, a0 + math.pi], [1.0, 1.0], device,
                                                          kind="discrete")
        if div == "Function":
            x = np.linspace(0.0, div_rad, 1000)
            if not self.div_2d:
                f = np.asarray(self.div_func(x, **self.div_args)) * np.sin(x)
                theta_lookup = sampling.inverse_cdf(x, f, device)
            else:
                f = np.asarray(self.div_func(x, **self.div_args))
                theta_fn = sampling.inverse_transform_sampler(x, f, device)
        elif div not in ("None", "Lambertian", "Isotropic"):
            raise RuntimeError(f"Unknown divergence '{div}'.")  # pragma: no cover

        # polarization
        polm = self.polarization
        if not no_pol:
            if polm == "xy":
                pol_fn = sampling.inverse_transform_sampler([0.0, math.pi / 2], [1.0, 1.0], device,
                                                            kind="discrete")
            elif polm == "List":
                pc.check_type("RaySource.pol_angles", self.pol_angles, (np.ndarray, list))
                probs = self.pol_probs if self.pol_probs is not None \
                    else np.ones_like(self.pol_angles)
                pol_fn = sampling.inverse_transform_sampler(self.pol_angles, probs, device,
                                                            kind="discrete")
            elif polm == "Function":
                pc.check_callable("RaySource.pol_func", self.pol_func)
                x = np.linspace(0.0, 2 * np.pi, 5000)
                f = np.asarray(self.pol_func(x, **self.pol_args))
                pol_fn = sampling.inverse_transform_sampler(x, f, device)
            elif polm not in ("x", "y", "Constant", "Uniform"):
                raise RuntimeError(f"Unknown polarization '{polm}'.")  # pragma: no cover

        def sample(gen):
            dev = gen.device
            weights = torch.full((N,), power / N, dtype=f32, device=dev)
            if not rgb_image:
                wavelengths = wavelength_fn(gen, N).to(f32)

            # starting positions
            if self._image is None:
                p = self.surface.random_positions(gen, N).to(f32)
            else:
                if one_pixel:
                    P = torch.zeros((N,), dtype=torch.int64, device=dev)
                else:
                    P = pixel_fn(sampling.stratified_interval_sampling(gen, N, 0.0, 1.0))
                rx, ry = sampling.stratified_rectangle_sampling(gen, N, 0.0, 1.0, 0.0, 1.0)
                p = self.image_positions(P, rx, ry).to(f32)
                if rgb_image:
                    wavelengths = color.random_wavelengths_from_srgb(gen, pix[P]).to(f32)

            if self.orientation == "Constant":
                s_or = s_const.expand(N, 3)
            elif self.orientation == "Converging":
                s_or = normalize_safe(conv - p)
            else:
                s_or = self.or_func(p[:, 0], p[:, 1], **self.or_args)

            if self.div_2d:
                alpha = alpha_fn(gen, N)

            if div == "None":
                s = s_or
            else:
                if div == "Lambertian" and not self.div_2d:
                    r, alpha = sampling.stratified_ring_sampling(gen, N, 0.0, div_sin, polar=True)
                    theta = torch.arcsin(r)
                elif div == "Lambertian":
                    theta = torch.arcsin(sampling.stratified_interval_sampling(gen, N, 0.0, div_sin))
                elif div == "Isotropic" and not self.div_2d:
                    r, alpha = sampling.stratified_ring_sampling(gen, N, 0.0, div_sin, polar=True)
                    # theta = arccos(1 - r²) rewritten via the half-angle
                    # identity: f32-stable for small cones, where 1 - r² rounds
                    # to ~6 discrete levels (ulp(1.0)=1.2e-7 vs r² ~ 1e-6) and
                    # would quantize the whole divergence distribution
                    theta = 2.0 * torch.arcsin(r * math.sqrt(0.5))
                elif div == "Isotropic":
                    theta = sampling.stratified_interval_sampling(gen, N, 0.0, div_rad)
                elif not self.div_2d:      # Function
                    r, alpha = sampling.stratified_ring_sampling(gen, N, 0.0, div_sin, polar=True)
                    theta = theta_lookup(r ** 2 / div_sin ** 2)
                else:
                    theta = theta_fn(gen, N)

                # local frame around s_or: sy = [1,0,0] × s_or (normalized), sx = s_or × sy
                fa = 1.0 / torch.sqrt(torch.clamp(1.0 - s_or[:, 0] ** 2, min=1e-12))
                sy = torch.stack([torch.zeros_like(fa), -s_or[:, 2] * fa, s_or[:, 1] * fa], dim=-1)
                sx = tcross(s_or, sy)
                th = theta[:, None]
                al = alpha[:, None]
                s = torch.cos(th) * s_or + torch.sin(th) * (torch.cos(al) * sx + torch.sin(al) * sy)

            # polarization
            if no_pol:
                pols = torch.full((N, 3), float("nan"), dtype=f32, device=dev)
            else:
                if polm == "x":
                    ang = torch.zeros((N,), dtype=f32, device=dev)
                elif polm == "y":
                    ang = torch.full((N,), math.pi / 2, dtype=f32, device=dev)
                elif polm == "xy":
                    ang = pol_fn(gen, N)
                elif polm == "Constant":
                    ang = torch.full((N,), math.radians(self.pol_angle), dtype=f32, device=dev)
                elif polm == "Uniform":
                    ang = sampling.stratified_interval_sampling(gen, N, 0.0, 2 * math.pi)
                else:       # List, Function
                    ang = torch.deg2rad(pol_fn(gen, N))

                # transport the xy-plane polarization onto each ray's transverse
                # plane. The in-plane frame axis comes from s_xy DIRECTLY
                # (|ps| = 1 by construction): 1/sqrt(1−s_z²) is an f32 trap —
                # normalize can round s_z one ulp above 1, the sqrt clamps to 0
                # and a guard factor would turn some polarization vectors into
                # garbage
                zero = torch.zeros_like(ang)
                pol0 = torch.stack([torch.cos(ang), torch.sin(ang), zero], dim=-1)
                rxy = torch.hypot(s[:, 0], s[:, 1])
                axial = rxy < 1e-9
                fa = 1.0 / torch.where(axial, 1.0, rxy)
                ps = torch.stack([s[:, 1] * fa, -s[:, 0] * fa, zero], dim=-1)
                A_ts = ps[:, 0] * pol0[:, 0] + ps[:, 1] * pol0[:, 1]
                A_tp = ps[:, 1] * pol0[:, 0] - ps[:, 0] * pol0[:, 1]
                pp_ = tcross(ps, s)
                pol_t = ps * A_ts[:, None] + pp_ * A_tp[:, None]
                # axial rays: the xy-plane polarization is already transverse
                pols = torch.where(axial[:, None], pol0, pol_t)

            return p, s.contiguous(), pols, weights, wavelengths
        return sample

    # ------------------------------------------------------------------
    def color(self, rendering_intent: str = "Ignore", clip: bool = False):
        """Mean color of the source (image mean color for image sources,
        spectrum color otherwise)."""
        if self._mean_img_color is not None:
            return tuple(float(v) for v in self._mean_img_color)
        return self.spectrum.color(rendering_intent, clip)

    # ------------------------------------------------------------------
    def __setattr__(self, key: str, val: Any) -> None:
        if key == "divergence":
            pc.check_type(key, val, str)
            pc.check_if_element(key, val, self.divergences)
        elif key == "orientation":
            pc.check_type(key, val, str)
            pc.check_if_element(key, val, self.orientations)
        elif key == "polarization":
            pc.check_type(key, val, str)
            pc.check_if_element(key, val, self.polarizations)
        elif key in ("power", "div_angle"):
            pc.check_type(key, val, (int, float))
            val = float(val)
            pc.check_above(key, val, 0)
            if key == "div_angle":
                pc.check_not_above(key, val, 90)
        elif key in ("pol_angle", "div_axis_angle"):
            pc.check_type(key, val, (int, float))
            val = float(val)
        elif key in ("div_func", "or_func", "pol_func"):
            pc.check_none_or_callable(key, val)
        elif key == "div_2d":
            pc.check_type(key, val, bool)
        elif key in ("s", "conv_pos") and val is not None:
            pc.check_type(key, val, (list, np.ndarray))
            val2 = np.asarray(val, dtype=np.float64)
            pc.check_finite(key, val2)
            if val2.shape[0] != 3:
                raise ValueError(f"{key} needs to have 3 elements.")
            if key == "s":
                val2 = val2 / np.linalg.norm(val2)
                if val2[2] <= 0:
                    raise ValueError("Ray orientation s needs a positive z-component.")
            super().__setattr__(key, val2)
            return
        elif key == "spectrum" and val is not None:
            pc.check_type(key, val, LightSpectrum)
        super().__setattr__(key, val)
