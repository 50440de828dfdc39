"""tqdm-backed progress bar for host-side loops.

Parity with reference ``optrace/progress_bar.py:6-40``. Used around
megabatch loops (iterative render) and focus-search sampling; never inside
jit-compiled code.
"""

from .global_options import global_options

try:
    from tqdm import tqdm as _tqdm_base

    class _tqdm(_tqdm_base):
        # no monitor thread: tqdm starts one with the first bar and keeps it
        # alive for the rest of the process; these bars are short and need none
        monitor_interval = 0
except ImportError:          # pragma: no cover - tqdm is baked into the image
    _tqdm = None


class ProgressBar:

    def __init__(self, text: str, steps: int) -> None:
        self.steps = steps
        self._bar = None
        if global_options.show_progress_bar and _tqdm is not None:
            self._bar = _tqdm(total=steps, desc=text, leave=False,
                              bar_format="{desc}: {percentage:3.0f}%|{bar}| {n_fmt}/{total_fmt}")

    def update(self, condition: bool = True) -> None:
        if self._bar is not None and condition:
            self._bar.update(1)

    def finish(self) -> None:
        if self._bar is not None:
            self._bar.n = self.steps
            self._bar.refresh()
            self._bar.close()
            self._bar = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finish()
        return False
