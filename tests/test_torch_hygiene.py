"""Hygiene of the port: it imports without JAX and without the JAX package,
its sources name neither, its entry points refuse to run without a CUDA
device unless the CPU is asked for, and its kernel wrappers take the plain
version for CPU tensors only. Its layers stay apart: the renders trace the
raytracer's compiled scene without building one of their own, the capture
layer names no kernel module, and the kernel modules import nothing of the
tracer.
"""

import ast
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import optrace_tpu_torch as otp
from optrace_tpu_torch.ops.cuda_run import conic_run
from optrace_tpu_torch.ops.cuda_binning import bin_xyzw_cuda
from optrace_tpu_torch.ops.cuda_trace import conic_step
from optrace_tpu_torch.presets.geometry import double_gauss

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "optrace_tpu_torch").rglob("*.py")) \
    + sorted((ROOT / "optrace_tpu_torch" / "csrc").glob("*.cu*")) \
    + [ROOT / "chip_smoke.py", ROOT / "tools" / "profile_port.py", ROOT / "tools" / "allreduce_probe.py"] \
    + sorted((ROOT / "examples_torch").glob("*.py"))
EXAMPLE_SCRIPTS = sorted(p.stem for p in (ROOT / "examples").glob("*.py"))
# the glob must reach the kernels, colour and image modules too
for _new in ("ops/cuda_trace.py", "csrc/trace_step.cuh", "csrc/conic_step.cu", "color/xyz.py", "color/luv.py",
             "color/srgb.py", "image/render_image.py", "image/base_image.py", "image/rgb_image.py",
             "geometry/surface/aspheric_surface.py", "geometry/surface/tilted_surface.py",
             "geometry/surface/slit_surface.py", "geometry/ideal_lens.py", "geometry/filter.py",
             "spectrum/transmission_spectrum.py", "presets/image.py", "parallel/checkpoint.py",
             "parallel/render.py", "ops/binning.py", "tracer/detector.py", "tracer/diff.py",
             "analysis/tma.py", "analysis/focus.py", "analysis/convolve.py", "presets/psf.py",
             "geometry/marker.py", "geometry/volume.py", "presets/geometry.py",
             "ops/bspline.py", "geometry/surface/function_surface.py",
             "geometry/surface/data_surface.py", "io/load.py", "io/__init__.py", "metadata.py",
             "plots/__init__.py", "plots/init.py", "plots/image_plots.py", "plots/spectrum_plots.py",
             "plots/chromaticity_plots.py", "plots/misc_plots.py", "gui/__init__.py",
             "gui/trace_gui.py", "gui/scene_plotting.py", "gui/interactors.py",
             "gui/property_browser.py", "gui/command_window.py", "parallel/graph.py",
             "csrc/bin_xyzw.cu"):
    assert ROOT / "optrace_tpu_torch" / _new in PORT_FILES, _new
# every example script of the JAX package has its port
for _name in EXAMPLE_SCRIPTS:
    assert ROOT / "examples_torch" / f"{_name}.py" in PORT_FILES, _name


def test_import_leaves_no_jax_behind():
    code = ("import sys; sys.path.insert(0, %r); import optrace_tpu_torch; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'optrace_tpu', 'triton')]; "
            "print(bad); sys.exit(1 if bad else 0)" % str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_import_needs_no_matplotlib():
    """The package imports where matplotlib is missing (the card machine
    has none): only ``optrace_tpu_torch.plots`` needs it."""
    code = ("import sys; sys.path.insert(0, %r); sys.modules['matplotlib'] = None; "
            "import optrace_tpu_torch as ot; "
            "print(ot.__version__, ot.load_zmx.__name__, ot.DataSurface2D.__name__); "
            "bad = [m for m in sys.modules if m.startswith('matplotlib') and sys.modules[m] is not None]; "
            "sys.exit(1 if bad else 0)" % str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.split() == [otp.__version__, "load_zmx", "DataSurface2D"]


@pytest.fixture(scope="module")
def imported_examples(tmp_path_factory):
    """Every script of examples_torch/ imported in one fresh interpreter in
    an empty directory, where matplotlib cannot be imported and building
    any object of the package raises: {script: "ok" or the error}, and the
    files the imports left behind."""
    where = tmp_path_factory.mktemp("imports")
    code = ("import importlib, json, sys; sys.path.insert(0, %r); sys.modules['matplotlib'] = None; "
            "import optrace_tpu_torch as ot; from optrace_tpu_torch.utils.base_class import BaseClass\n"
            "def refuse(self, *a, **k): raise RuntimeError('built at import: ' + type(self).__name__)\n"
            "BaseClass.__init__ = refuse; out = {}\n"
            "for name in %r:\n"
            "    try:\n"
            "        importlib.import_module('examples_torch.' + name); out[name] = 'ok'\n"
            "    except BaseException as e:\n"
            "        out[name] = repr(e)\n"
            "bad = [m for m in sys.modules if m.startswith(('matplotlib', 'jax', 'optrace_tpu.')) "
            "and sys.modules[m] is not None]\n"
            "print(json.dumps(dict(scripts=out, bad=bad)))" % (str(ROOT), EXAMPLE_SCRIPTS))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=where)
    assert res.returncode == 0, res.stdout + res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    return out, sorted(os.listdir(where))


@pytest.mark.parametrize("name", EXAMPLE_SCRIPTS)
def test_importing_an_example_runs_nothing(imported_examples, name):
    """An example does its work in ``main`` and draws in ``plot``: importing
    it builds no object of the package, writes no file and needs no
    matplotlib (the GPU machine has none)."""
    from optrace_tpu_torch.utils.base_class import BaseClass
    assert issubclass(otp.Raytracer, BaseClass) and issubclass(otp.SphericalSurface, BaseClass)
    out, left = imported_examples
    assert out["scripts"][name] == "ok"
    assert out["bad"] == [] and left == []


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_name_neither_jax_nor_the_jax_package(path):
    text = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+jax\b", text, re.M)
    # ``optrace_tpu`` as a module name: imported, or used as a dotted name
    # (file paths in docstrings, ``optrace_tpu/...``, are references only)
    assert not re.search(r"^\s*(import|from)\s+optrace_tpu(\.|\s|$)", text, re.M)
    assert not re.search(r"\boptrace_tpu\.\w", text)


def _imported_modules(path) -> list:
    """Every module a file imports, wherever the import stands, as written
    (relative ones with their leading dots)."""
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = "." * node.level + (node.module or "")
            out += [base] if node.module else [base + a.name for a in node.names]
    return out


@pytest.mark.parametrize("name", ["parallel/render.py", "tracer/diff.py"])
def test_renders_build_no_scene_of_their_own(name):
    """The fused and sharded render and the design render trace through
    ``Raytracer.trace_program`` and take their detector from
    ``Raytracer.detector_target``: they call none of the raytracer's private
    methods that compile a scene and read none of its trace settings."""
    text = (ROOT / "optrace_tpu_torch" / name).read_text()
    for private in ("_build_steps", "_make_source_fn", "_section_z_bounds"):
        assert private not in text, private
    assert not re.search(r"\bRT\.(n0|no_pol|use_hurb|HURB_FACTOR)\b", text)


def test_the_capture_layer_imports_no_kernel_module():
    """``parallel/graph.py`` counts the kernels through ``utils/tracing.py``
    alone: it imports no module of ``ops``."""
    mods = _imported_modules(ROOT / "optrace_tpu_torch" / "parallel" / "graph.py")
    assert mods and not [m for m in mods if m in ("..ops", "optrace_tpu_torch.ops")
                         or m.startswith(("..ops.", "optrace_tpu_torch.ops."))]


@pytest.mark.parametrize("path", sorted((ROOT / "optrace_tpu_torch" / "ops").glob("*.py")),
                         ids=lambda p: p.name)
def test_kernel_modules_import_nothing_of_the_tracer(path):
    """The layer of the kernels and their plain versions lies below the
    tracer: no module of ``ops`` imports one of ``tracer``, and none keeps
    a launch counter's reset of its own (``utils/tracing.py:reset_counts``)."""
    mods = _imported_modules(path)
    assert not [m for m in mods if m.startswith(("..tracer", "optrace_tpu_torch.tracer"))]
    assert "reset_launch_counts" not in path.read_text()


def _cpu_raytracer(**kw):
    RT = otp.Raytracer(outline=[-150, 150, -150, 150, -50001, 180], device="cpu", **kw)
    RT.add(otp.RaySource(otp.Point(), divergence="Isotropic", orientation="Converging",
                         conv_pos=[0, 0, 0], div_angle=0.03, pos=[0, 0, -50000],
                         spectrum=otp.LightSpectrum("Constant")))
    RT.add(double_gauss())
    return RT


@pytest.mark.parametrize("entry", ["Raytracer", "make_fused_render", "make_generator",
                                   "resolve_device", "iterative_render", "render_huge",
                                   "convolve", "default_mesh", "make_sharded_render"])
def test_entry_points_raise_without_cuda(entry):
    """``device=None`` means the CUDA device: with no card it raises and
    never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    calls = {
        "Raytracer": lambda: otp.Raytracer(outline=[-1, 1, -1, 1, -1, 1]),
        "make_fused_render": lambda: otp.make_fused_render(_cpu_raytracer(no_pol=True), 100,
                                                           Nx=8, Ny=8),
        "make_generator": lambda: otp.make_generator(0),
        "resolve_device": lambda: otp.resolve_device(None),
        # a default-device raytracer is never built without a card, so its
        # renders cannot start on the CPU by accident
        "iterative_render": lambda: otp.Raytracer(outline=[-1, 1, -1, 1, -1, 1]).iterative_render(100),
        "render_huge": lambda: otp.Raytracer(outline=[-1, 1, -1, 1, -1, 1]).render_huge(100),
        # the design render and the focus search run on the raytracer's
        # device; the convolution takes its own
        "convolve": lambda: otp.convolve(otp.presets.psf.gaussian(sig=20.0),
                                         otp.presets.psf.gaussian(sig=0.5)),
        # the default mesh lies on the CUDA device, before any process group
        # is looked for; so does the sharded render's default mesh
        "default_mesh": lambda: otp.default_mesh(),
        "make_sharded_render": lambda: otp.make_sharded_render(_cpu_raytracer(no_pol=True), 100,
                                                               Nx=8, Ny=8),
    }
    with pytest.raises(RuntimeError, match="CUDA"), otp.global_options.no_progress_bar():
        calls[entry]()



def test_cpu_only_on_request():
    assert otp.resolve_device("cpu") == torch.device("cpu")
    RT = _cpu_raytracer(no_pol=True)
    assert RT.device == torch.device("cpu")
    assert all(v.device.type == "cpu" for st in RT._build_steps() for v in st.sfns.params.values())


def test_wrappers_on_cpu_count_no_launch():
    """The trace and the render on the CPU go through the wrappers' plain
    versions: the launch counters stay where they were."""
    before = (conic_run.launches, bin_xyzw_cuda.launches, conic_step.launches)
    RT = _cpu_raytracer(no_pol=True)
    with otp.global_options.no_warnings(), otp.global_options.no_progress_bar():
        RT.trace(2000)
        render, _ = otp.make_fused_render(RT, 2000, extent=[-2, 2, -2, 2], Nx=16, Ny=16,
                                          device="cpu")
        img = render(otp.make_generator(0, "cpu"))
        rimg = RT.detector_image(extent=[-2, 2, -2, 2])
    assert img.shape == (16, 16, 4) and float(img[..., 3].sum()) > 0
    assert rimg.power() > 0
    x = torch.zeros((4, 3))
    conic_step(x, x + torch.tensor([0.0, 0.0, 1.0]), torch.ones(4), torch.ones(4), torch.ones(4) * 1.5,
               rho=0.05, k=0.0, z_min_rel=0.0, z_max_rel=0.3, r_ap=3.0)
    assert (conic_run.launches, bin_xyzw_cuda.launches, conic_step.launches) == before


def test_flags_and_unported_parts_raise():
    """The port's own flags exist and default to on; parts that are not
    ported raise and name the ROADMAP instead of returning something."""
    go = otp.global_options
    assert go.cuda_trace is True and go.cuda_binning is True
    # fusing the planar steps was a tie on the card (PERF.md): off, as in the JAX package
    assert go.cuda_fuse_planar is False
    assert not hasattr(go, "pallas_trace") and not hasattr(go, "pallas_binning")
    assert not hasattr(go, "pallas_fuse_planar")
    with pytest.raises(TypeError):
        go.cuda_binning = 1
    with pytest.raises(TypeError):
        go.cuda_fuse_planar = "on"
    # the mesh axis of the sharded render, as in the JAX package
    assert go.mesh_axis_name == "rays"
    with pytest.raises(TypeError, match="string"):
        go.mesh_axis_name = 0
    # function surfaces are ported: a lens of them traces. A generic surface
    # has no plain description (its closures hold the surface object). The
    # render over several devices takes a torch.distributed device mesh
    from optrace_tpu_torch.tracer.scene_compile import compile_surface, surface_fns
    RTf = otp.Raytracer(outline=[-5, 5, -5, 5, -10, 60], device="cpu")
    RTf.add(otp.RaySource(otp.CircularSurface(r=2.0), pos=[0, 0, -5]))
    RTf.add(otp.Lens(otp.FunctionSurface2D(r=3, func=lambda x, y: 0.02 * x ** 2 + 0.01 * y ** 2),
                     otp.FunctionSurface1D(r=3, func=lambda r: -r ** 2 / 60), n=otp.RefractionIndex(
                         "Constant", n=1.5), pos=[0, 0, 0], d=1.0))
    with go.no_warnings(), go.no_progress_bar():
        RTf.trace(500)
    assert [st.sfns.kind for st in RTf._build_steps()][:2] == ["generic", "generic"]
    assert RTf.rays.w_list[:, -2].sum() > 0
    with pytest.raises(NotImplementedError, match="compile_surface"):
        surface_fns("generic", {}, "cpu")
    with pytest.raises(TypeError, match="not a surface"):
        compile_surface(otp.Point(), "cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        _cpu_raytracer(no_pol=True).render_huge(100, mesh=object())
    # HURB and image sources are ported: they run
    RT = _cpu_raytracer(use_hurb=True)
    with go.no_warnings(), go.no_progress_bar():
        RT.trace(100)
    assert RT.rays.N == 100
    assert otp.RaySource(otp.presets.image.grid([1, 1])).surface.dim.tolist() == [1.0, 1.0]


@pytest.mark.cuda
def test_wrappers_launch_on_the_card():
    """On CUDA tensors the wrappers launch their kernels (run with
    ``python3 chip_smoke.py`` for the full check)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    before = bin_xyzw_cuda.launches
    x = torch.zeros(8, device="cuda")
    bin_xyzw_cuda(x, x, x + 1, x + 550, 4, 4, (-1.0, 1.0, -1.0, 1.0))
    assert bin_xyzw_cuda.launches == before + 1
    before = conic_step.launches
    p = torch.zeros((8, 3), device="cuda")
    s = p + torch.tensor([0.0, 0.0, 1.0], device="cuda")
    conic_step(p, s, x + 1, x + 1, x + 1.5, rho=0.05, k=0.0, z_min_rel=0.0, z_max_rel=0.3, r_ap=3.0)
    assert conic_step.launches == before + 1
