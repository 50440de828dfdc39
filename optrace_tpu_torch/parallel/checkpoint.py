"""Checkpoint/resume for long batched renders.

Counterpart of ``optrace_tpu/parallel/checkpoint.py``: a render job
periodically saves the accumulated detector tiles plus the batch counter, so
a render of 10⁸ rays and more survives an interruption and resumes with the
same remaining batches. Each batch draws from a ``torch.Generator`` seeded
from (seed, batch index) alone, so the stream of a batch does not depend on
which batches ran before it. In the sharded render each rank draws its share
of a batch from (seed, batch index, rank); rank 0 draws the stream of the
unsharded batch.

A checkpoint of the sharded render holds the summed tile, which every rank
has: only rank 0 of the group writes the file, every rank reads it, and all
ranks wait at a barrier after each save, so no rank runs ahead of a
checkpoint that is still being written.

The tiles are summed in f64 on the device they arrive on, in the order of
the batches, and come to the host when the checkpoint is saved or the image
is read. A batch is a function of its generator on every device: on a CUDA
device the binning kernel sums in fixed point, whose result does not depend
on the order of the rays, and a replayed graph equals the eager batch. So a
resumed render equals the uninterrupted one bit for bit.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

_MASK64 = (1 << 64) - 1


def shard_seed(seed: int, batch_index: int, rank: int) -> int:
    """A fixed integer mix (splitmix64 finalizer) of (seed, batch index,
    rank) to a 63-bit generator seed: neighbouring seeds, indices and ranks
    give unrelated streams, and the result depends on nothing else. Rank 0
    adds nothing to the mix, so its seed is :func:`batch_seed`."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + (int(batch_index) + 1) * 0xBF58476D1CE4E5B9
         + int(rank) * 0xD6E8FEB86659FD93) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def batch_seed(seed: int, batch_index: int) -> int:
    """The generator seed of one batch of an unsharded render."""
    return shard_seed(seed, batch_index, 0)


def batch_generator(seed: int, batch_index: int, device, rank: int = 0) -> torch.Generator:
    """The generator of one batch (of one rank's share of it) on ``device``,
    see :func:`shard_seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(shard_seed(seed, batch_index, rank))
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

    With ``group`` (a ``torch.distributed`` process group) only its rank 0
    writes the file, and every save ends at a barrier of the group.
    """

    def __init__(self, path: str = None, total_batches: int = 1, seed: int = 0,
                 group=None) -> None:
        self.path = path
        self.total_batches = int(total_batches)
        self.seed = int(seed)
        self.group = group
        self._img = None        # f64: a tensor once a tile was added, numpy after load()
        self._done = 0
        if path is not None and os.path.isfile(path):
            self.load()

    # ------------------------------------------------------------------
    def generator(self, batch_index: int, device, rank: int = 0) -> torch.Generator:
        """Per-batch generator (of one rank's share of the batch),
        independent of completion order."""
        return batch_generator(self.seed, batch_index, device, rank)

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
        if self.group is None or dist.get_rank(self.group) == 0:
            tmp = self.path + ".tmp.npz"
            np.savez_compressed(tmp, img=self._host_image(), done=self._done,
                                total=self.total_batches, seed=self.seed)
            os.replace(tmp, self.path)
        if self.group is not None:
            dist.barrier(group=self.group)

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
