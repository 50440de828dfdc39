"""Checkpoint/resume for long batched renders.

Counterpart of ``optrace_tpu/parallel/checkpoint.py``: a render job
periodically saves the accumulated detector tiles plus the batch counter, so
a render of 10⁸ rays and more survives an interruption and resumes with the
same remaining batches. Each batch draws from a ``torch.Generator`` seeded
from (seed, batch index) alone, so the stream of a batch does not depend on
which batches ran before it.

The tiles are summed in f64 on the device they arrive on and come to the
host when the checkpoint is saved or the image is read. On the CPU a
resumed render equals the uninterrupted one exactly; on a CUDA device each
tile carries the rounding of the binning kernel's f32 atomic sums, whose
order differs from run to run.
"""

import os

import numpy as np
import torch

_MASK64 = (1 << 64) - 1


def batch_seed(seed: int, batch_index: int) -> int:
    """A fixed integer mix (splitmix64 finalizer) of (seed, batch index) to a
    63-bit generator seed: neighbouring seeds and indices give unrelated
    streams, and the result depends on nothing else."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + (int(batch_index) + 1) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def batch_generator(seed: int, batch_index: int, device) -> torch.Generator:
    """The generator of one batch on ``device``, see :func:`batch_seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(batch_seed(seed, batch_index))
    return gen


class RenderCheckpoint:
    """Additive image accumulator with .npz checkpointing.

    Usage::

        ck = RenderCheckpoint("render.ckpt.npz", total_batches=100)
        render, _ = make_fused_render(RT, N_batch, ...)
        for i in ck.remaining():
            ck.add(render(ck.generator(i, RT.device)))
            if i % 10 == 9:
                ck.save()
        img = ck.image()
    """

    def __init__(self, path: str = None, total_batches: int = 1, seed: int = 0) -> None:
        self.path = path
        self.total_batches = int(total_batches)
        self.seed = int(seed)
        self._img = None        # f64: a tensor once a tile was added, numpy after load()
        self._done = 0
        if path is not None and os.path.isfile(path):
            self.load()

    # ------------------------------------------------------------------
    def generator(self, batch_index: int, device) -> torch.Generator:
        """Per-batch generator, independent of completion order."""
        return batch_generator(self.seed, batch_index, device)

    def remaining(self):
        """Iterator over the batch indices still to run."""
        return range(self._done, self.total_batches)

    @property
    def done(self) -> int:
        return self._done

    def add(self, tile) -> None:
        """Accumulate one rendered (Ny, Nx, 4) tile (tensor or host array)."""
        if not isinstance(tile, torch.Tensor):
            tile = torch.from_numpy(np.asarray(tile, dtype=np.float64))
        tile = tile.detach().to(torch.float64)
        if self._img is None:
            self._img = tile.clone()
        else:
            if not isinstance(self._img, torch.Tensor):
                self._img = torch.from_numpy(self._img).to(tile.device)
            self._img += tile
        self._done += 1

    def _host_image(self) -> np.ndarray:
        return self._img.cpu().numpy() if isinstance(self._img, torch.Tensor) else self._img

    # ------------------------------------------------------------------
    def save(self) -> None:
        tmp = self.path + ".tmp.npz"
        np.savez_compressed(tmp, img=self._host_image(), done=self._done,
                            total=self.total_batches, seed=self.seed)
        os.replace(tmp, self.path)

    def load(self) -> None:
        with np.load(self.path) as d:
            self._img = np.array(d["img"], dtype=np.float64)
            self._done = int(d["done"])
            if int(d["total"]) != self.total_batches or int(d["seed"]) != self.seed:
                raise ValueError("Checkpoint was created with a different "
                                 "batch count or seed.")

    def image(self, scale: float = None) -> np.ndarray:
        """Accumulated XYZW image (host, f64); scaled by 1/total_batches by
        default so batch weights sum to the true source power."""
        if self._img is None:
            raise RuntimeError("No batches accumulated.")
        s = scale if scale is not None else 1.0 / self.total_batches
        return self._host_image() * s
