"""User-facing image base class with physical geometry
(counterpart of ``optrace_tpu/image/base_image.py``).

Data layout: element [0, 0] is the lower-left corner (negative x and y);
images loaded from files are flipped accordingly.
"""

import os
from typing import Any

import numpy as np

try:
    import cv2
except ImportError:      # pragma: no cover
    cv2 = None

from ..utils.base_class import BaseClass
from ..utils.property_checker import PropertyChecker as pc

SPHERE_PROJECTION_METHODS = ["Equidistant", "Orthographic", "Equal-Area", "Stereographic"]


class BaseImage(BaseClass):

    def __init__(self, data, s=None, extent=None, projection: str = None,
                 quantity: str = "", limit: float = None, **kwargs) -> None:
        self._new_lock = False
        self._data = self._load_image(data) if isinstance(data, str) else data

        if extent is None and s is None:
            raise ValueError("Either s or extent need to be provided for Images")
        if extent is None:
            pc.check_type("s", s, (list, tuple, np.ndarray))
            s2 = np.asarray(s, dtype=np.float64)
            pc.check_finite("s", s2)
            if s2.shape[0] != 2:
                raise ValueError("s needs to have 2 elements.")
            pc.check_above("s[0]", s2[0], 0)
            pc.check_above("s[1]", s2[1], 0)
            self.extent = [-s2[0] / 2, s2[0] / 2, -s2[1] / 2, s2[1] / 2]
        else:
            self.extent = extent

        self.quantity = quantity
        self.projection = projection
        self.limit = limit
        super().__init__(**kwargs)
        self._new_lock = True

    # ------------------------------------------------------------------
    def _load_image(self, path: str) -> np.ndarray:
        if cv2 is None:
            raise ImportError("cv2 required for image file loading")
        if not cv2.haveImageReader(path):
            raise IOError(f"Can't find/process file {path}")
        image = cv2.imread(path, flags=cv2.IMREAD_COLOR)
        image = np.flipud(image)     # element [0,0] = lower-left corner
        if type(self).__name__ == "RGBImage":
            return cv2.cvtColor(image, cv2.COLOR_BGR2RGB) / 255.0
        return cv2.cvtColor(image, cv2.COLOR_BGR2GRAY) / 255.0

    # ------------------------------------------------------------------
    @property
    def shape(self):
        """data shape, y-dimension first"""
        return self._data.shape

    @property
    def data(self) -> np.ndarray:
        return self._data.copy()

    @property
    def s(self):
        """side lengths [sx, sy] in mm"""
        return [float(self.extent[1] - self.extent[0]), float(self.extent[3] - self.extent[2])]

    @property
    def Apx(self) -> float:
        """area per pixel in mm²"""
        return float(self.s[0] * self.s[1] / (self.shape[1] * self.shape[0]))

    # ------------------------------------------------------------------
    def save(self, path: str, params: list = None, flip: bool = False) -> None:
        """Save as image file (rescaled to square pixels)."""
        if cv2 is None:
            raise ImportError("cv2 required for image file saving")
        folder = os.path.split(path)[0]
        if not (folder == "" or os.path.isdir(folder)) or not cv2.haveImageWriter(path):
            raise IOError(f"Can't create/write file {path}")

        if self.s[0] > self.s[1]:
            siz = (int(self.shape[0] * self.s[0] / self.s[1]), self.shape[0])
        else:
            siz = (self.shape[1], int(self.shape[1] * self.s[0] / self.s[1]))

        img = cv2.resize(self._data, siz, interpolation=cv2.INTER_LINEAR)
        if self._data.ndim == 2:
            if (maxi := img.max()):
                img = img / maxi
            img = np.broadcast_to(img[:, :, np.newaxis], [img.shape[0], img.shape[1], 3])
        img2 = (255 * img).astype(np.uint8)
        img2 = cv2.cvtColor(img2, cv2.COLOR_RGB2BGR)
        img2 = np.flipud(img2)
        if flip:
            img2 = np.fliplr(np.flipud(img2))
        cv2.imwrite(path, img2, params if params is not None else [])

    def profile(self, x: float = None, y: float = None):
        """Nearest-pixel profile cut at fixed x or y.

        :return: (bin edges, list of channel profiles)"""
        img = self._data
        if x is not None:
            if not self.extent[0] <= x <= self.extent[1]:
                raise ValueError(f"Position x={x} is outside the image x-extent of {self.extent[:2]}")
            bins = np.linspace(self.extent[2], self.extent[3], self.shape[0] + 1)
            ind = int((x - self.extent[0]) / self.s[0] * self.shape[1] * (1 - 1e-12))
            iml = [img[:, ind]] if img.ndim == 2 else [img[:, ind, 0], img[:, ind, 1], img[:, ind, 2]]
        elif y is not None:
            if not self.extent[2] <= y <= self.extent[3]:
                raise ValueError(f"Position y={y} is outside the image y-extent of {self.extent[2:]}")
            bins = np.linspace(self.extent[0], self.extent[1], self.shape[1] + 1)
            ind = int((y - self.extent[2]) / self.s[1] * self.shape[0] * (1 - 1e-12))
            iml = [img[ind]] if img.ndim == 2 else [img[ind, :, 0], img[ind, :, 1], img[ind, :, 2]]
        else:
            raise ValueError("Either x or y parameter must be provided.")
        return bins, iml

    # ------------------------------------------------------------------
    def __setattr__(self, key: str, val: Any) -> None:
        if key == "extent":
            pc.check_type(key, val, (list, tuple, np.ndarray))
            val2 = np.asarray(val, dtype=np.float64)
            pc.check_finite(key, val2)
            if val2.shape[0] != 4:
                raise ValueError("Extent needs to have 4 elements.")
            if val2[0] > val2[1] or val2[2] > val2[3]:
                raise ValueError("Extent needs [x0, x1, y0, y1] with x0 < x1 and y0 < y1.")
            super().__setattr__(key, val2)
            return
        if key == "_data":
            pc.check_type(key, val, np.ndarray)
            val2 = np.asarray(val, dtype=np.float64)
            pc.check_finite(key, val2)
            super().__setattr__(key, val2)
            return
        if key == "limit" and val is not None:
            pc.check_type(key, val, (float, int))
            pc.check_above(key, val, 0)
            val = float(val)
        elif key == "quantity":
            pc.check_type(key, val, str)
        elif key == "projection" and val is not None:
            pc.check_type(key, val, str)
            pc.check_if_element(key, val, SPHERE_PROJECTION_METHODS)
        super().__setattr__(key, val)
