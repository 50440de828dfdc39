"""Three-channel sRGB image (counterpart of ``optrace_tpu/image/rgb_image.py``)."""

from typing import Any

import numpy as np

from .base_image import BaseImage
from ..utils.property_checker import PropertyChecker as pc
from ..color import srgb_to_xyz, srgb_linear_to_srgb


class RGBImage(BaseImage):

    def __init__(self, data, s=None, extent=None, **kwargs) -> None:
        self._new_lock = False
        super().__init__(data, s, extent, **kwargs)
        self._new_lock = True

    def to_grayscale_image(self):
        """Channel-average luminance conversion (Y of XYZ, gamma compressed)."""
        from .grayscale_image import GrayscaleImage
        xyz_y = srgb_to_xyz(self._data)[:, :, 1]
        gray_srgb = np.clip(srgb_linear_to_srgb(xyz_y).numpy(), 0, 1)
        return GrayscaleImage(gray_srgb, extent=self.extent, desc=self.desc,
                              long_desc=self.long_desc, quantity=self.quantity,
                              projection=self.projection, limit=self.limit)

    def __setattr__(self, key: str, val: Any) -> None:
        if key == "_data":
            pc.check_type(key, val, np.ndarray)
            val2 = np.asarray(val, dtype=np.float64)
            pc.check_finite(key, val2)
            if val2.ndim != 3 or val2.shape[2] != 3:
                raise ValueError(f"Image needs three dimensions with 3 channels, got {val2.shape}.")
            if (min_ := np.min(val2)) < 0.0:
                raise ValueError(f"Negative value {min_} inside the image; data must be in [0, 1].")
            if (max_ := np.max(val2)) > 1.0:
                raise ValueError(f"Value {max_} inside the image; data must be in [0, 1].")
            super().__setattr__(key, val2)
            return
        super().__setattr__(key, val)
