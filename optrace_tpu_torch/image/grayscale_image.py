"""Grayscale (gamma-compressed sRGB) image
(counterpart of ``optrace_tpu/image/grayscale_image.py``)."""

from typing import Any

import numpy as np

from .scalar_image import ScalarImage


class GrayscaleImage(ScalarImage):

    def __init__(self, data, s=None, extent=None, **kwargs) -> None:
        self._new_lock = False
        super().__init__(data, s, extent, **kwargs)
        self._new_lock = True

    def to_rgb_image(self):
        """Convert to a 3-channel RGBImage."""
        from .rgb_image import RGBImage
        return RGBImage(np.repeat(self._data[:, :, np.newaxis], 3, axis=2), extent=self.extent,
                        desc=self.desc, long_desc=self.long_desc, quantity=self.quantity,
                        projection=self.projection, limit=self.limit)

    def __setattr__(self, key: str, val: Any) -> None:
        if key == "_data" and isinstance(val, np.ndarray):
            if (max_ := val.max()) > 1.0:
                raise ValueError(f"There is a value of {max_} inside the image. "
                                 "Make sure all image data is in the range [0, 1].")
        super().__setattr__(key, val)
