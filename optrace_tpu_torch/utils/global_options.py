"""Global option singleton.

Counterpart of ``optrace_tpu/utils/global_options.py``: wavelength range,
progress-bar/warning toggles, dark mode for plots, spectral colormap hook,
and context managers. The port's own flags are ``cuda_trace`` and
``cuda_binning``, which route the trace runs and the detector binning
through the hand-written CUDA kernels when the tensors lie on a CUDA
device, and ``cuda_fuse_planar``, which lets a run hold tilted planes and
aperture absorbers. ``mesh_axis_name`` names the device-mesh axis over
which ``Raytracer.render_huge(mesh=...)`` shards its rays.
"""

import contextlib
from typing import Callable, Optional


class _GlobalOptions:

    def __init__(self) -> None:
        self._multithreading: bool = True
        self._show_progress_bar: bool = True
        self._show_warnings: bool = True
        self._wavelength_range: list = [380.0, 780.0]
        self._spectral_colormap: Optional[Callable] = None
        self._plot_dark_mode: bool = True
        self._ui_dark_mode: bool = True
        self._float_dtype = "float32"
        # an atomic histogram is the natural form of the binning on a GPU
        self._cuda_binning: bool = True
        self._cuda_trace: bool = True
        self._cuda_fuse_planar: bool = False
        self._mesh_axis_name: str = "rays"

    # ------------------------------------------------------------------
    @property
    def multithreading(self) -> bool:
        return self._multithreading

    @multithreading.setter
    def multithreading(self, val: bool) -> None:
        self._check_bool("multithreading", val)
        self._multithreading = val

    @property
    def show_progress_bar(self) -> bool:
        return self._show_progress_bar

    @show_progress_bar.setter
    def show_progress_bar(self, val: bool) -> None:
        self._check_bool("show_progress_bar", val)
        self._show_progress_bar = val

    @property
    def show_warnings(self) -> bool:
        return self._show_warnings

    @show_warnings.setter
    def show_warnings(self, val: bool) -> None:
        self._check_bool("show_warnings", val)
        self._show_warnings = val

    @property
    def wavelength_range(self) -> list:
        return self._wavelength_range

    @wavelength_range.setter
    def wavelength_range(self, val) -> None:
        if not isinstance(val, (list, tuple)) or len(val) != 2:
            raise TypeError("wavelength_range must be a 2-element list.")
        lo, hi = float(val[0]), float(val[1])
        if lo > 380.0 or hi < 780.0:
            # the reference requires the range to include the visible band
            # (global_options wavelength bounds semantics)
            raise ValueError("wavelength_range must include [380, 780] nm.")
        self._wavelength_range = [lo, hi]

    @property
    def spectral_colormap(self) -> Optional[Callable]:
        return self._spectral_colormap

    @spectral_colormap.setter
    def spectral_colormap(self, val: Optional[Callable]) -> None:
        if val is not None and not callable(val):
            raise TypeError("spectral_colormap must be callable or None.")
        self._spectral_colormap = val

    @property
    def plot_dark_mode(self) -> bool:
        return self._plot_dark_mode

    @plot_dark_mode.setter
    def plot_dark_mode(self, val: bool) -> None:
        self._check_bool("plot_dark_mode", val)
        self._plot_dark_mode = val

    @property
    def ui_dark_mode(self) -> bool:
        return self._ui_dark_mode

    @ui_dark_mode.setter
    def ui_dark_mode(self, val: bool) -> None:
        self._check_bool("ui_dark_mode", val)
        self._ui_dark_mode = val

    # ---- numeric options ----------------------------------------------
    @property
    def float_dtype(self) -> str:
        return self._float_dtype

    @float_dtype.setter
    def float_dtype(self, val: str) -> None:
        if val not in ("float32", "float64"):
            raise ValueError("float_dtype must be 'float32' or 'float64'.")
        self._float_dtype = val

    @property
    def cuda_binning(self) -> bool:
        """Route the fused render's XYZW binning on a CUDA device through
        the atomic-add histogram kernel (ops/cuda_binning.py). When off,
        the plain ``index_add_`` version (ops/binning.py) runs instead.
        On by default."""
        return self._cuda_binning

    @cuda_binning.setter
    def cuda_binning(self, val: bool) -> None:
        self._check_bool("cuda_binning", val)
        self._cuda_binning = val

    @property
    def cuda_trace(self) -> bool:
        """Run consecutive conic/flat refract steps on a CUDA device
        through the whole-run trace kernel (ops/cuda_run.py): the ray state
        stays in registers across all surfaces of a run. Applies to f32
        state that needs no gradient; f64 and differentiable traces keep
        the plain PyTorch loop. When off, every run takes the plain loop.
        On by default."""
        return self._cuda_trace

    @cuda_trace.setter
    def cuda_trace(self, val: bool) -> None:
        self._check_bool("cuda_trace", val)
        self._cuda_trace = val

    @property
    def cuda_fuse_planar(self) -> bool:
        """Let a trace run hold the cheap planar steps too: refractions on
        tilted planes, and aperture absorbers (circle, ring, rectangle,
        slit) without edge diffraction that lie between two refractions of
        the run. A system with a stop between its lens groups then traces
        in one run instead of two runs around an unrolled step. Counterpart
        of ``pallas_fuse_planar``. Even aspheres join a run whatever this
        flag says. The default is the setting that ``chip_smoke.py``
        measured as the faster one for a render batch of the double Gauss
        on an H100, and off where the two tie (PERF.md, Findings)."""
        return self._cuda_fuse_planar

    @cuda_fuse_planar.setter
    def cuda_fuse_planar(self, val: bool) -> None:
        self._check_bool("cuda_fuse_planar", val)
        self._cuda_fuse_planar = val

    @property
    def mesh_axis_name(self) -> str:
        """The axis of a ``torch.distributed`` device mesh that the sharded
        render splits its rays over (``Raytracer.render_huge(mesh=...)``)."""
        return self._mesh_axis_name

    @mesh_axis_name.setter
    def mesh_axis_name(self, val: str) -> None:
        if not isinstance(val, str):
            raise TypeError("mesh_axis_name must be a string.")
        self._mesh_axis_name = val

    # ------------------------------------------------------------------
    @staticmethod
    def _check_bool(name: str, val) -> None:
        if not isinstance(val, bool):
            raise TypeError(f"{name} must be bool.")

    @contextlib.contextmanager
    def no_progress_bar(self):
        """Context manager that temporarily disables the progress bar."""
        old = self._show_progress_bar
        self._show_progress_bar = False
        try:
            yield
        finally:
            self._show_progress_bar = old

    @contextlib.contextmanager
    def no_warnings(self):
        """Context manager that temporarily disables optrace warnings."""
        old = self._show_warnings
        self._show_warnings = False
        try:
            yield
        finally:
            self._show_warnings = old

    def __repr__(self) -> str:
        vals = {k.lstrip("_"): v for k, v in self.__dict__.items()}
        return f"GlobalOptions({vals})"


global_options = _GlobalOptions()
