"""Single-channel image of an arbitrary physical quantity
(counterpart of ``optrace_tpu/image/scalar_image.py``)."""

from typing import Any

import numpy as np

from .base_image import BaseImage
from ..utils.property_checker import PropertyChecker as pc


class ScalarImage(BaseImage):

    def __init__(self, data, s=None, extent=None, **kwargs) -> None:
        self._new_lock = False
        super().__init__(data, s, extent, **kwargs)
        self._new_lock = True

    def __setattr__(self, key: str, val: Any) -> None:
        if key == "_data":
            pc.check_type(key, val, np.ndarray)
            if np.asarray(val).ndim != 2:
                raise ValueError(f"ScalarImage needs a 2D array, got shape {np.asarray(val).shape}.")
            if np.min(val) < 0:
                raise ValueError("Negative values inside scalar image.")
        super().__setattr__(key, val)
