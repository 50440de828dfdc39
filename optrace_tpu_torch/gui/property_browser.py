"""Property browser: inspectable dictionaries of the GUI, raytracer, shown
rays, presets and TMA cardinal points (counterpart of
``optrace_tpu/gui/property_browser.py``; behavioral parity with reference
``optrace/gui/property_browser.py:14``, which renders the same dicts in a
traitsui ValueEditor tree; here they are plain attributes so tests and
scripts can read them headlessly).
"""

from typing import Any

import numpy as np
import torch

from ..utils.base_class import BaseClass
from .. import presets as otp
from ..presets import spectral_lines as spec_lines


RAY_LEGEND = (
    "p:      position                      s:    unity direction vector           "
    "s_un:   direction vector\n"
    "l:      ray length to next point      ol:   optical length to next point     "
    "pol:    polarization unity vector\n"
    "w:      power                         wv:   wavelength                       "
    "snum:   source number\n"
    "index:  ray index                     n:    ambient refractive index")

TMA_LEGEND = (
    "abcd:  ABCD Matrix                bfl:  back focal length       d:  thickness\n"
    "efl:   effective focal length     ffl:  front focal length\n"
    "n1:    index before setup         n2:   index after setup")

UNIT_LABEL = "Distances in mm, optical powers in dpt"


class PropertyBrowser:

    def __init__(self, gui) -> None:
        """:param gui: reference to the TraceGUI"""
        self.gui = gui
        self.raytracer = gui.raytracer

        self.ray_dict: dict = {}         #: properties of the displayed rays
        self.card_dict: dict = {}        #: cardinal points / TMA per system+lens
        self.raytracer_dict: dict = {}   #: raytracer state
        self.trace_gui_dict: dict = {}   #: TraceGUI display properties
        self.scene_dict: dict = {}       #: scene plotting state
        self.preset_dict: dict = {}      #: preset catalogs

        self.ray_legend = RAY_LEGEND
        self.tma_legend = TMA_LEGEND
        self.unit_label = UNIT_LABEL

    def update_dict(self) -> None:
        """Rebuild all browser dictionaries (reference
        property_browser.py:101-113)."""
        self.raytracer_dict = self._gen_dict_repr(self.raytracer.__dict__)
        self.ray_dict = self._gen_dict_repr(self.gui.scene._ray_property_dict)
        self.scene_dict = self._gen_dict_repr(self.gui.scene.__dict__)
        self.trace_gui_dict = self._gen_dict_repr(self._gui_props())
        self.card_dict = self._gen_dict_repr(self._gen_cardinals())
        self.preset_dict = self._gen_dict_repr(self._gen_pdict())

    # ------------------------------------------------------------------

    def _gui_props(self) -> dict:
        """Display-property snapshot (the trait_get() analog)."""
        g = self.gui
        keys = ["ray_count", "rays_visible", "ray_opacity", "ray_width",
                "coloring_mode", "image_mode", "image_pixels", "log_image",
                "flip_detector_image", "projection_method",
                "focus_search_method", "focus_search_single_source",
                "detector_image_single_source", "activate_filter",
                "minimalistic_view", "hide_labels", "vertical_labels",
                "high_contrast", "maximize_scene", "detector_selection",
                "source_selection"]
        return {k: getattr(g, k) for k in keys if hasattr(g, k)}

    def _gen_dict_repr(self, val: Any, rec: int = 0, max_rec: int = 20):
        """Representable form of nested state: arrays to float64, unknown
        objects to str, recursion-bounded (reference
        property_browser.py:115-152). A tensor is shown as an array; one of
        10⁵ elements and more, such as the sections that the raytracer keeps
        on its device, stays where it is, as a large array does."""
        if rec > max_rec:
            return f"Recursion larger than {max_rec}, ignoring remaining recursions."

        if isinstance(val, (type(None), bool, int, float, str, BaseClass)):
            return val
        if isinstance(val, torch.Tensor):
            return self._gen_dict_repr(val.detach().cpu().numpy(), rec) if val.numel() < 1e5 \
                else val
        if isinstance(val, np.ndarray):
            if val.size == 1:
                return self._gen_dict_repr(val.item(), rec + 1)
            return np.array(val, dtype=np.float64) if val.size < 1e5 else val
        if isinstance(val, list):
            return [self._gen_dict_repr(el, rec + 1) for el in val]
        if isinstance(val, tuple):
            return tuple(self._gen_dict_repr(el, rec + 1) for el in val)
        if isinstance(val, dict):
            return {k: self._gen_dict_repr(v, rec + 1) for k, v in val.items()}
        if isinstance(val, (np.floating, np.integer, np.bool_)):
            return val.item()
        return str(val)

    def _gen_pdict(self) -> dict:
        """Preset catalogs by module (reference property_browser.py:154-165)."""
        pdict = {"presets.image": otp.image.__dict__,
                 "presets.light_spectrum": otp.light_spectrum.__dict__,
                 "presets.refraction_index": otp.refraction_index.__dict__,
                 "presets.psf": otp.psf.__dict__,
                 "presets.spectral_lines": otp.spectral_lines.__dict__}
        return {key0: {k: v for k, v in val0.items() if not k.startswith("__")
                       and "module" not in str(v) and "class" not in str(v)}
                for key0, val0 in pdict.items()}

    def _gen_cardinals(self) -> dict:
        """Cardinal points / TMA of the whole system and each lens at the
        Fraunhofer F, d, C lines (reference property_browser.py:167-197)."""
        def set_cdict(group, cdict, name):
            cdict[name] = {}
            for wl in spec_lines.FdC:
                tma = group.tma(wl=wl)
                cdict[name][f"{wl:.4g}nm"] = dict(
                    nodal_points=tma.nodal_points, d=tma.d, n1=tma.n1, n2=tma.n2,
                    focal_points=tma.focal_points, focal_lengths=tma.focal_lengths,
                    focal_lengths_n=tma.focal_lengths_n,
                    principal_points=tma.principal_points,
                    vertex_points=tma.vertex_points, abcd=tma.abcd,
                    efl=tma.efl, efl_n=tma.efl_n,
                    powers=tma.powers, powers_n=tma.powers_n,
                    bfl=tma.bfl, ffl=tma.ffl,
                    optical_center=tma.optical_center)

        try:
            cdict = {}
            set_cdict(self.raytracer, cdict, "System")
            for i, L in enumerate(self.raytracer.lenses):
                set_cdict(L, cdict, f"Lens {i}")
            return cdict
        except Exception as e:   # invalid geometry / no rotational symmetry
            return dict(exception=repr(e))
