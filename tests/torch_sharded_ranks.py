"""Rank functions of the sharded-render tests (tests/test_torch_sharded.py).

Each function runs in a process of its own, started by :func:`spawn_ranks`
with ``torch.multiprocessing`` over a gloo process group on the CPU. A
spawned process imports the module of its function again, so this module
imports only torch, numpy and the port: importing JAX there would cost
seconds a rank. Each rank writes what it found to ``workdir`` as
``.npz`` files that the test reads.
"""

import datetime
import os
import time

import numpy as np
import torch
import torch.distributed as dist

import optrace_tpu_torch as otp
from optrace_tpu_torch.parallel import checkpoint as ck_mod

EXT = (-2.0, 2.0, -2.0, 2.0)
NX = 63
PG_TIMEOUT_S = 60          # a rendezvous or a collective that hangs fails its test


def simple_rt():
    """The scene of tests/test_tracer.py::TestSharded: a collimated
    monochromatic beam through an ideal lens onto a 4 mm detector."""
    RT = otp.Raytracer(outline=[-5, 5, -5, 5, -10, 60], device="cpu")
    RT.add(otp.RaySource(otp.CircularSurface(r=1.0), pos=[0, 0, -5], divergence="None",
                         spectrum=otp.LightSpectrum("Monochromatic", wl=550.0)))
    RT.add(otp.IdealLens(r=3, D=50, pos=[0, 0, 0]))
    RT.add(otp.Detector(otp.RectangularSurface(dim=[4, 4]), pos=[0, 0, 10]))
    return RT


def spawn_ranks(fn, world: int, workdir, *args, timeout: float = 120.0) -> None:
    """Run ``fn(rank, world, workdir, *args)`` in ``world`` spawned
    processes and wait at most ``timeout`` seconds; a rank that raises, or a
    run that outlasts the limit, fails the caller and leaves no process."""
    ctx = torch.multiprocessing.start_processes(fn, args=(world, str(workdir)) + args,
                                                nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks of {fn.__name__} did not end in {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


def _init(rank: int, world: int, workdir: str) -> None:
    torch.set_num_threads(1)
    otp.global_options.show_progress_bar = False
    dist.init_process_group("gloo", init_method="file://" + os.path.join(workdir, "pg_init"),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))


def sharded_tile(rank: int, world: int, workdir: str, n: int, batch_index: int, seed: int) -> None:
    """One step of ``make_sharded_render`` on the default mesh, after the
    refusal of a batch that the world size does not divide."""
    _init(rank, world, workdir)
    try:
        mesh = otp.default_mesh(device="cpu")
        try:
            otp.make_sharded_render(simple_rt(), n + 2, mesh=mesh, extent=list(EXT), Nx=NX, Ny=NX)
            indivisible = "no error"
        except ValueError as e:
            indivisible = f"ValueError: {e}"
        step, ext = otp.make_sharded_render(simple_rt(), n, mesh=mesh, extent=list(EXT),
                                            Nx=NX, Ny=NX)
        tile = step(batch_index, seed)
        np.savez(os.path.join(workdir, f"tile{rank}.npz"), tile=tile.numpy(), ext=np.array(ext),
                 mesh_size=mesh.size(), rank=step.rank, indivisible=indivisible)
    finally:
        dist.destroy_process_group()


class Interrupted(Exception):
    pass


def huge_interrupted_and_resumed(rank: int, world: int, workdir: str, n: int, batch: int) -> None:
    """``render_huge(mesh=...)`` uninterrupted; then stopped after its
    second checkpoint and resumed from the file. Records which rank wrote
    the checkpoint."""
    _init(rank, world, workdir)
    writes = []
    real_savez = ck_mod.np.savez_compressed

    def counting_savez(*a, **kw):
        writes.append(1)
        return real_savez(*a, **kw)
    ck_mod.np.savez_compressed = counting_savez
    try:
        mesh = otp.default_mesh(device="cpu")
        path = os.path.join(workdir, "huge.ckpt.npz")
        kw = dict(batch_size=batch, extent=list(EXT), checkpoint_every=1, mesh=mesh)
        full = simple_rt().render_huge(n, **kw)
        real_save = ck_mod.RenderCheckpoint.save

        def save_then_stop(self):
            real_save(self)
            if self.done == 2:
                raise Interrupted
        ck_mod.RenderCheckpoint.save = save_then_stop
        try:
            simple_rt().render_huge(n, checkpoint_path=path, **kw)
            raise AssertionError("render_huge was not interrupted")
        except Interrupted:
            pass
        finally:
            ck_mod.RenderCheckpoint.save = real_save
        done_at_cut = ck_mod.RenderCheckpoint(path, -(-n // batch)).done
        resumed = simple_rt().render_huge(n, checkpoint_path=path, **kw)
        np.savez(os.path.join(workdir, f"huge{rank}.npz"), full=full.data, resumed=resumed.data,
                 writes=len(writes), done_at_cut=done_at_cut)
    finally:
        ck_mod.np.savez_compressed = real_savez
        dist.destroy_process_group()
