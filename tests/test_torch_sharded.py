"""The sharded render of the port (``parallel/render.py:make_sharded_render``,
``default_mesh``, ``Raytracer.render_huge(mesh=...)``) on the CPU.

Ranks are processes spawned with ``torch.multiprocessing`` over a gloo
process group with a ``file://`` rendezvous under the test's own directory,
so no two xdist workers contend for a port; their functions live in
tests/torch_sharded_ranks.py. Every rendezvous and collective has a time
limit of its own, and so has every spawn. World-size-1 cases run in the
test's process.

- World 4, on the scene of tests/test_tracer.py::TestSharded (63² pixels,
  extent ±2): every rank returns the whole image, its W sum is 1 within
  1e-3, and it equals the sum of the four ranks' single-process fused
  renders (each from its rank's generator, divided by 4) to 1e-6 of the
  maximum. The JAX package's sharded render on the 8 virtual CPU devices
  of tests/conftest.py agrees within the Monte-Carlo error of the spot's
  centroid and RMS radius, and its power within 1e-3.
- World 1: ``render_huge(N, mesh=...)`` equals ``render_huge(N)`` bit for
  bit, because rank 0 draws the unsharded stream.
- World 2: an interrupted and resumed ``render_huge(mesh=...)`` equals the
  uninterrupted one bit for bit, and only rank 0 wrote the checkpoint.
"""

import datetime

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

import optrace_tpu_torch as otp
from optrace_tpu_torch.parallel.checkpoint import batch_generator, batch_seed, shard_seed

from torch_sharded_ranks import (EXT, NX, PG_TIMEOUT_S, simple_rt, spawn_ranks, sharded_tile,
                                 huge_interrupted_and_resumed)

N4 = 4 * 4096                   # rays of a world-4 batch: 4096 a rank
BATCH_INDEX, SEED = 3, 11


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("world4")
    spawn_ranks(sharded_tile, 4, workdir, N4, BATCH_INDEX, SEED)
    out = []
    for r in range(4):
        with np.load(workdir / f"tile{r}.npz") as d:
            out.append({k: d[k] for k in d.files})
    return out


@pytest.fixture
def world1(tmp_path):
    """A gloo group of one process (this one) and its default mesh."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg_init'}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    try:
        yield otp.default_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def _spot(img):
    """Power, centroid (x, y) and RMS radius of an XYZW image over EXT, by
    pixel centres, and the spreads a ray of centroid and RMS radius (their
    Monte-Carlo standard errors times the square root of the ray count)."""
    W = np.asarray(img, dtype=np.float64)[..., 3]
    Ny, Nx = W.shape
    xs = EXT[0] + (np.arange(Nx) + 0.5) * (EXT[1] - EXT[0]) / Nx
    ys = EXT[2] + (np.arange(Ny) + 0.5) * (EXT[3] - EXT[2]) / Ny
    X, Y = np.meshgrid(xs, ys)
    P = W.sum()
    cx, cy = (W * X).sum() / P, (W * Y).sum() / P
    r2 = (X - cx) ** 2 + (Y - cy) ** 2
    m2 = (W * r2).sum() / P
    var_r2 = (W * r2 ** 2).sum() / P - m2 ** 2
    return P, cx, cy, np.sqrt(m2), np.sqrt(m2 / 2), np.sqrt(var_r2) / (2 * np.sqrt(m2))


# ----------------------------------------------------------------------
# world 4

def test_world4_every_rank_holds_the_whole_image(world4):
    tiles = [o["tile"] for o in world4]
    assert tiles[0].shape == (NX, NX, 4) and tiles[0].dtype == np.float32
    assert [int(o["rank"]) for o in world4] == [0, 1, 2, 3]
    assert all(int(o["mesh_size"]) == 4 for o in world4)
    for t in tiles[1:]:
        np.testing.assert_array_equal(t, tiles[0])
    assert tiles[0][..., 3].sum() == pytest.approx(1.0, abs=1e-3)
    np.testing.assert_allclose(world4[0]["ext"], EXT)


def test_world4_equals_the_sum_of_the_ranks_renders(world4):
    """The all-reduced image against single-process fused renders driven
    with each rank's stream, divided by the world size and summed here."""
    render, _ = otp.make_fused_render(simple_rt(), N4 // 4, extent=list(EXT), Nx=NX, Ny=NX,
                                      device="cpu")
    with torch.no_grad():
        ref = sum(render(batch_generator(SEED, BATCH_INDEX, "cpu", rank=r)) / 4 for r in range(4))
    ref = ref.numpy()
    tile = world4[0]["tile"]
    assert np.abs(tile - ref).max() <= 1e-6 * np.abs(ref).max()
    # the four shards are different rays: no rank repeats another's stream
    with torch.no_grad():
        t0, t1 = (render(batch_generator(SEED, BATCH_INDEX, "cpu", rank=r)) for r in (0, 1))
    assert not torch.equal(t0, t1)


def test_world4_agrees_with_the_jax_sharded_render(world4):
    """The JAX package's make_sharded_render on its 8 virtual CPU devices,
    same scene, same ray count: equal power within 1e-3, centroid and RMS
    radius within four standard errors of their difference."""
    import jax
    import optrace_tpu as ot
    from optrace_tpu.parallel import make_sharded_render, default_mesh

    RT = ot.Raytracer(outline=[-5, 5, -5, 5, -10, 60])
    RT.add(ot.RaySource(ot.CircularSurface(r=1.0), pos=[0, 0, -5], divergence="None",
                        spectrum=ot.LightSpectrum("Monochromatic", wl=550.0)))
    RT.add(ot.IdealLens(r=3, D=50, pos=[0, 0, 0]))
    RT.add(ot.Detector(ot.RectangularSurface(dim=[4, 4]), pos=[0, 0, 10]))
    mesh = default_mesh()
    assert mesh.devices.size == 8, "tests/conftest.py provides 8 virtual CPU devices"
    run, _ = make_sharded_render(RT, N4, mesh=mesh, extent=list(EXT), Nx=NX, Ny=NX)
    img_j = np.asarray(run(jax.random.PRNGKey(0)))

    Pt, cxt, cyt, rmst, se_c_t, se_r_t = _spot(world4[0]["tile"])
    Pj, cxj, cyj, rmsj, se_c_j, se_r_j = _spot(img_j)
    n = N4
    assert Pt == pytest.approx(Pj, abs=1e-3)
    se_c = np.hypot(se_c_t, se_c_j) / np.sqrt(n)
    se_r = np.hypot(se_r_t, se_r_j) / np.sqrt(n)
    assert abs(cxt - cxj) <= 4 * se_c and abs(cyt - cyj) <= 4 * se_c, (cxt, cxj, cyt, cyj, se_c)
    assert abs(rmst - rmsj) <= 4 * se_r, (rmst, rmsj, se_r)
    assert 0.3 < rmst < 0.4       # the lit disc of radius 0.5 mm halfway to the focus


def test_world4_refuses_an_indivisible_batch(world4):
    """Every rank refused a batch of N4 + 2 rays before it rendered."""
    for o in world4:
        assert str(o["indivisible"]) == f"ValueError: N_batch={N4 + 2} must be divisible by " \
                                        "the mesh size 4."


# ----------------------------------------------------------------------
# world 2 and world 1

def test_world2_resumed_render_is_exact_and_rank0_writes(tmp_path):
    spawn_ranks(huge_interrupted_and_resumed, 2, tmp_path, 8192, 2048)
    out = [dict(np.load(tmp_path / f"huge{r}.npz")) for r in range(2)]
    for o in out:
        assert int(o["done_at_cut"]) == 2
        np.testing.assert_array_equal(o["resumed"], o["full"])
    np.testing.assert_array_equal(out[0]["full"], out[1]["full"])
    assert out[0]["full"][..., 3].sum() == pytest.approx(1.0, abs=1e-3)
    # rank 0 wrote two saves before the cut, and after it one a batch and
    # the closing one; rank 1 none
    assert int(out[0]["writes"]) == 2 + 2 + 1 and int(out[1]["writes"]) == 0


def test_world1_render_huge_equals_the_unsharded_render(world1):
    kw = dict(batch_size=2048, extent=list(EXT))
    with otp.global_options.no_progress_bar():
        sharded = simple_rt().render_huge(6144, mesh=world1, **kw)
        plain = simple_rt().render_huge(6144, **kw)
    np.testing.assert_array_equal(sharded.data, plain.data)
    assert sharded.power() == pytest.approx(1.0, abs=1e-3)
    # the step itself: rank 0 of one rank renders the unsharded batch stream
    step, _ = otp.make_sharded_render(simple_rt(), 2048, mesh=world1, extent=list(EXT),
                                      Nx=NX, Ny=NX)
    render, _ = otp.make_fused_render(simple_rt(), 2048, extent=list(EXT), Nx=NX, Ny=NX,
                                      device="cpu")
    with torch.no_grad():
        assert torch.equal(step(5, 2), render(batch_generator(2, 5, "cpu")))
    assert step.rank == 0 and dist.get_world_size(step.group) == 1


def test_mesh_axis_name_option(world1):
    """render_huge takes the mesh axis named by global_options."""
    go = otp.global_options
    mesh_t = otp.default_mesh("t", device="cpu")
    old = go.mesh_axis_name
    try:
        with go.no_progress_bar():
            with pytest.raises(ValueError, match="no axis 'rays'"):
                simple_rt().render_huge(2048, mesh=mesh_t, extent=list(EXT))
            go.mesh_axis_name = "t"
            img = simple_rt().render_huge(2048, mesh=mesh_t, extent=list(EXT))
    finally:
        go.mesh_axis_name = old
    assert img.power() == pytest.approx(1.0, abs=1e-3)


# ----------------------------------------------------------------------
# errors and seeds

def test_default_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="torchrun.*init_process_group"):
        otp.default_mesh(device="cpu")


@pytest.mark.parametrize("case", ["not_a_mesh", "other_device", "render_huge_not_a_mesh"])
def test_sharded_render_refuses(world1, case):
    RT = simple_rt()
    if case == "not_a_mesh":
        with pytest.raises(TypeError, match="DeviceMesh"):
            otp.make_sharded_render(RT, 100, mesh=object())
    elif case == "other_device":
        mesh_cuda = DeviceMesh("cuda", [0], mesh_dim_names=("rays",))
        with pytest.raises(ValueError, match="cuda devices, the raytracer on cpu"):
            otp.make_sharded_render(RT, 100, mesh=mesh_cuda)
    else:
        with pytest.raises(TypeError, match="DeviceMesh"), otp.global_options.no_progress_bar():
            RT.render_huge(100, mesh=[0])


def test_shard_seeds_are_distinct_and_rank0_is_the_batch_seed():
    seeds = {shard_seed(5, b, r) for b in range(64) for r in range(8)}
    assert len(seeds) == 64 * 8 and all(0 <= v < 2 ** 63 for v in seeds)
    assert all(shard_seed(5, b, 0) == batch_seed(5, b) for b in range(64))
    assert shard_seed(5, 3, 1) == shard_seed(5, 3, 1) != shard_seed(6, 3, 1)
    a = torch.rand(4, generator=batch_generator(5, 3, "cpu", rank=2))
    b = torch.rand(4, generator=otp.RenderCheckpoint(None, 9, seed=5).generator(3, "cpu", rank=2))
    assert torch.equal(a, b)
