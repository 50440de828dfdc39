"""Centralized constructor/property validation helpers.

Parity with reference ``optrace/property_checker.py:1-43``: small static
methods raising TypeError/ValueError with uniform messages. Kept host-side
(never traced) — validation happens at scene-construction time, outside jit.
"""

import numpy as np


class PropertyChecker:

    @staticmethod
    def check_type(key: str, val, type_) -> None:
        if not isinstance(val, type_):
            types = type_ if isinstance(type_, tuple) else (type_,)
            names = ", ".join(getattr(t, "__name__", str(t)) for t in types)
            raise TypeError(f"Property '{key}' needs to be of type(s) {names}, "
                            f"but is {type(val).__name__}.")

    @staticmethod
    def check_not_above(key: str, val, limit) -> None:
        if val > limit:
            raise ValueError(f"Property '{key}' needs to be below or equal to {limit}, but is {val}.")

    @staticmethod
    def check_not_below(key: str, val, limit) -> None:
        if val < limit:
            raise ValueError(f"Property '{key}' needs to be above or equal to {limit}, but is {val}.")

    @staticmethod
    def check_above(key: str, val, limit) -> None:
        if not val > limit:
            raise ValueError(f"Property '{key}' needs to be above {limit}, but is {val}.")

    @staticmethod
    def check_below(key: str, val, limit) -> None:
        if not val < limit:
            raise ValueError(f"Property '{key}' needs to be below {limit}, but is {val}.")

    @staticmethod
    def check_if_element(key: str, val, choices) -> None:
        if val not in choices:
            raise ValueError(f"Property '{key}' must be one of {choices}, but is '{val}'.")

    @staticmethod
    def check_callable(key: str, val) -> None:
        if not callable(val):
            raise TypeError(f"Property '{key}' needs to be callable, but is {type(val).__name__}.")

    @staticmethod
    def check_none_or_callable(key: str, val) -> None:
        if val is not None and not callable(val):
            raise TypeError(f"Property '{key}' needs to be callable or None, but is {type(val).__name__}.")

    @staticmethod
    def check_vector_3d(key: str, val) -> np.ndarray:
        arr = np.asarray(val, dtype=np.float64)
        if arr.shape != (3,):
            raise TypeError(f"Property '{key}' must be a 3-element vector.")
        return arr

    @staticmethod
    def check_finite(key: str, val) -> None:
        if not np.all(np.isfinite(val)):
            raise ValueError(f"Property '{key}' must be finite.")
