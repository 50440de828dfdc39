"""The generic step's hand-written kernel on the CPU: the recorded sag
(``ops/sag_program.py``) and the kernel's plain version
(``ops/cuda_generic.py:generic_hit_reference``) against the eager route,
which step takes which route, and what the wrapper hands the kernel and
counts (the launch itself through a stand-in library that computes the
plain version into the wrapper's buffers). The kernel on the card:
``python3 chip_smoke.py`` (rows ``generic_hit@keratoconus``, ``@cosine``,
``@ops``). No JAX."""

import contextlib
import ctypes
import types

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import optrace_tpu_torch as ot
from optrace_tpu_torch.ops import cuda_generic, geom, sag_program
from optrace_tpu_torch.tracer import trace_core
from optrace_tpu_torch.tracer.scene_compile import compile_surface
from optrace_tpu_torch.tracer.trace_core import TraceStep

from benchmark.scene_keratoconus import cone_sag
from examples_torch.cosine_surfaces import lens_surfaces

N = 6000
ULP1 = 2.0 ** -23       # the last place of 1


def _cone():
    conic = ot.ConicSurface(r=5.0, R=7.8, k=-0.25)
    return ot.FunctionSurface2D(r=5.0, func=cone_sag, func_args=dict(conic=conic, h0=0.02, sigma_x=0.8,
                                                                     sigma_y=0.8, x0=1.1, y0=-1.4))


def _radial():
    return ot.FunctionSurface1D(r=3.0, func=lambda r: -r ** 2 / 60 + 1e-3 * r ** 3)


def _rotated():
    surf = ot.FunctionSurface2D(r=3.0, func=lambda x, y: 0.02 * x ** 2 + 0.01 * y ** 2 - 0.003 * x * y)
    surf.rotate(30)
    surf.flip()
    return surf


SURFACES = {"cone": _cone, "cosine": lambda: lens_surfaces()[0], "radial": _radial, "rotated": _rotated}


def _rays(sfns, dtype=torch.float32, seed=0):
    """Rays in the surface's frame: starting 2 mm before its extent (the
    standoff advance moves them), across its aperture and a little beyond,
    a tenth of them dead."""
    g = torch.Generator().manual_seed(seed)
    r = float(sfns.params["r"])
    zmin = float(sfns.params["z_min_rel"])
    xy = (torch.rand((N, 2), generator=g, dtype=torch.float64) * 2 - 1) * 1.1 * r
    p = torch.cat([xy, torch.full((N, 1), zmin - 2.0, dtype=torch.float64)], dim=1)
    d = torch.cat([(torch.rand((N, 2), generator=g, dtype=torch.float64) - 0.5) * 0.2,
                   torch.ones((N, 1), dtype=torch.float64)], dim=1)
    s = d / d.norm(dim=1, keepdim=True)
    hw = torch.rand(N, generator=g) > 0.1
    return p.to(dtype), s.to(dtype), hw


def _same(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b)) if a.is_floating_point() else (a == b)).all())


@pytest.mark.parametrize("name", sorted(SURFACES))
def test_the_recorded_program_gives_the_eager_bits(name):
    """The plain version over the recorded sag against the eager route in
    f32 on the CPU: the sag, the solve's t, valid and ill, the hit, the new
    positions and the broken count bit for bit; the normals by forward mode
    through the program within NORMAL_ULPS of the jvp's."""
    surf = SURFACES[name]()
    sfns = compile_surface(surf, "cpu")
    gen = sfns.generic
    assert sfns.kind == "generic" and gen.sag is not None and gen.mask is None and gen.normals_rel is None
    assert gen.device is None      # no program on the card for a CPU surface
    p, s, hw = _rays(sfns)
    params = sfns.params
    assert _same(gen.sag.replay(p[:, 0], p[:, 1]), surf._sag(p[:, 0], p[:, 1]))

    step = TraceStep(sfns, "refract")
    p_e, hit_e, ill_e, n_broken_e = trace_core._surface_hit(step, p, s, hw)
    ps = geom.advance_to_standoff(p, s, params["z_min_rel"], hw)
    t_e, valid_e, _ = sfns.hit_fn(params, ps, s)
    n_e = sfns.normal_fn(params, p_e[:, 0], p_e[:, 1])

    ref = cuda_generic.generic_hit_reference(gen, params, p, s, hw, normals=True)
    for key, eager in (("p", p_e), ("hit", hit_e), ("ill", ill_e), ("t", t_e), ("valid", valid_e),
                       ("n_broken", n_broken_e)):
        assert _same(ref[key], eager), key
    assert 0 < int(hit_e.sum()) < N and int(valid_e.sum()) > N // 2
    assert float((ref["normals"] - n_e).abs().max()) <= cuda_generic.NORMAL_ULPS * ULP1
    # the op codes, as the kernel runs them, evaluate the same function
    x, y = p_e[:, 0], p_e[:, 1]
    assert torch.allclose(sag_program.evaluate(gen.sag, x, y), surf._sag(x, y), rtol=0, atol=4e-7)


def _item_sag(x, y):
    return 0.01 * x * x * float(torch.tensor(2.0).item()) + (x * 0.0).sum().item() * y


def _cumsum_sag(x, y):
    return 0.01 * torch.cumsum(x, 0) * 0 + 0.02 * x * x


def _data_surface():
    xy = np.linspace(-3, 3, 51)
    X, Y = np.meshgrid(xy, xy)
    return ot.DataSurface2D(r=3.0, data=(-(X ** 2 + Y ** 2) / 60).T)


EAGER = ("data_surface", "item", "cumsum", "f64", "grad", "forward")


@pytest.mark.parametrize("case", EAGER)
def test_what_stays_eager(case, monkeypatch):
    """A data surface's spline, a sag with ``.item()``, one with
    ``torch.cumsum``, f64 state, a parameter that requires grad and an
    active forward-mode level keep the eager route, which counts the step
    in ``generic_hit.eager_steps`` where it runs on the card (the device
    test stood in for: every case has a reason before the device's)."""
    monkeypatch.setattr(cuda_generic, "_on_card", lambda t: True)
    dtype = torch.float64 if case == "f64" else torch.float32
    surf = {"data_surface": _data_surface,
            "item": lambda: ot.FunctionSurface2D(r=3.0, func=_item_sag),
            "cumsum": lambda: ot.FunctionSurface2D(r=3.0, func=_cumsum_sag)}.get(case, _rotated)()
    sfns = compile_surface(surf, "cpu", dtype)
    assert sfns.kind == "generic"
    if case == "grad":
        sfns = sfns._replace(params=dict(sfns.params, r=sfns.params["r"].clone().requires_grad_()))
    p, s, hw = _rays(sfns, dtype)
    step = TraceStep(sfns, "refract")
    before = cuda_generic.generic_hit.eager_steps
    with fwAD.dual_level() if case == "forward" else contextlib.nullcontext():
        reason = cuda_generic.refusal(sfns.generic, sfns.params, p, s)
        p_new, hit, ill, n = trace_core._generic_step(step, p, s, hw)
    want = {"f64": "not f32", "grad": "derivative", "forward": "forward-mode"}.get(case, "did not record")
    assert want in reason, reason
    assert cuda_generic.generic_hit.eager_steps == before + 1
    assert n.shape == (N, 3) and int(hit.sum()) > 0
    monkeypatch.undo()
    recorded = compile_surface(_rotated(), "cpu")
    assert "CUDA" in cuda_generic.refusal(recorded.generic, recorded.params, p.float(), s.float())


# ----------------------------------------------------------------------
# the launch, through a stand-in for the library

_CT = {torch.float32: ctypes.c_float, torch.uint8: ctypes.c_uint8, torch.int32: ctypes.c_int32}


def _view(ptr, shape, dtype):
    n = int(np.prod(shape)) if shape else 1
    a = np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(_CT[dtype])), shape=(n,))
    return torch.from_numpy(a).view(shape)


class _StandInLib:
    """``generic_hit_launch`` with the C signature, on host pointers: checks
    the programs it is handed and writes the plain version's outputs into
    the wrapper's buffers."""

    def __init__(self, gen):
        self.gen, self.calls = gen, 0

    def generic_hit_launch(self, p, s, hw, n, zmin, zmax, r, sag_code, sag_n, sag_consts, sag_nc, sag_out,
                           mask_code, mask_n, mask_consts, mask_nc, mask_out, n_slots, iters, eps, c_eps,
                           n_eps, standoff, p_new, hit, ill, normals, t, valid, broken, stream):
        f32, u8 = torch.float32, torch.uint8
        gen = self.gen
        assert _view(sag_code, (sag_n,), torch.int32).tolist() == list(gen.sag.code)
        assert _view(sag_consts, (sag_nc,), f32).tolist() == list(gen.sag.consts) and sag_out == gen.sag.out
        assert mask_n == 0 and n_slots == gen.sag.n_regs - sag_nc and iters == cuda_generic.ITERS
        assert (eps, c_eps, n_eps, standoff) == tuple(float(np.float32(v)) for v in (
            geom.C_EPS / 10.0, geom.C_EPS, geom.N_EPS, geom.ADVANCE_STANDOFF))
        params = {k: _view(v, (), f32) for k, v in (("z_min_rel", zmin), ("z_max_rel", zmax), ("r", r))}
        ref = cuda_generic.generic_hit_reference(gen, params, _view(p, (n, 3), f32), _view(s, (n, 3), f32),
                                                 _view(hw, (n,), u8).bool(), normals=normals is not None)
        for ptr, key, shape in ((p_new, "p", (n, 3)), (normals, "normals", (n, 3)), (t, "t", (n,))):
            if ptr is not None:
                _view(ptr, shape, f32).copy_(ref[key])
        for ptr, key in ((hit, "hit"), (ill, "ill"), (valid, "valid"), (broken, "broken")):
            if ptr is not None:
                _view(ptr, (n,), u8).copy_(ref[key])
        self.calls += 1
        return 0


@pytest.mark.parametrize("action", ["refract", "absorb"])
def test_the_kernel_route_counts(action, monkeypatch):
    """On the kernel route (the card stood in for), a generic step is one
    launch: the wrapper hands the kernel the recorded program and the
    buffers the plain version fills, counts the launch and adds rays × 43
    sag evaluations to ``geom.generic_sag.sag_evals`` for a refraction
    (42 for the solve, one for the value and both partials of the normals),
    rays × 42 for a step without normals, and no eager step."""
    sfns = compile_surface(_cone(), "cpu")
    gen = sfns.generic
    gen = gen._replace(device=cuda_generic._on_device(gen.sag, "cpu") + (None, None))
    sfns = sfns._replace(generic=gen)
    lib = _StandInLib(gen)
    monkeypatch.setattr(cuda_generic, "_on_card", lambda t: True)
    monkeypatch.setattr(cuda_generic, "_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    p, s, hw = _rays(sfns, seed=1)
    before = (cuda_generic.generic_hit.launches, cuda_generic.generic_hit.eager_steps,
              geom.generic_sag.sag_evals)
    normals = action == "refract"
    p_new, hit, ill, n = trace_core._generic_step(TraceStep(sfns, action), p, s, hw)
    evals = 43 if normals else 42
    assert cuda_generic.sag_evals(normals) == evals
    assert (cuda_generic.generic_hit.launches, cuda_generic.generic_hit.eager_steps,
            geom.generic_sag.sag_evals) == (before[0] + 1, before[1], before[2] + evals * N)
    assert lib.calls == 1 and (n is None) == (not normals)
    ref = cuda_generic.generic_hit_reference(gen, sfns.params, p, s, hw, normals=normals)
    assert _same(p_new, ref["p"]) and _same(hit, ref["hit"]) and _same(ill, ref["ill"])
    out = cuda_generic.generic_hit(gen, sfns.params, p, s, hw, normals, debug=True)
    for key in ("t", "valid", "broken", "n_broken"):
        assert _same(out[key], ref[key]), key


def test_the_op_set():
    """What the recorder keeps and how: PyTorch's special cases of pow, the
    division by a number as the product with its f64 reciprocal, a reversed
    division as reciprocal and product, comparisons and masks as bool
    programs; the kernel's enum in ``csrc/generic_hit.cu`` is
    ``sag_program.OPS`` in order."""
    import pathlib
    import re
    src = (pathlib.Path(cuda_generic.__file__).parent.parent / "csrc" / "generic_hit.cu").read_text()
    enum = dict((m.group(1).lower(), int(m.group(2))) for m in re.finditer(r"OP_(\w+) = (\d+)", src))
    assert enum == sag_program.OP

    def ops(fn, kind="f"):
        prog = sag_program.record(fn, kind)
        return None if prog is None else [sag_program.OPS[sag_program.decode(w)[0]] for w in prog.code]
    assert ops(lambda x, y: x ** 2 + x ** 3 + x ** -2 + x ** 0.5 + x ** -1 + x ** 2.5 + x ** 1 + x ** 0) == [
        "sqr", "cube", "add", "invsqr", "add", "sqrt", "add", "recip", "add", "pow", "add", "copy", "add",
        "one", "add"]
    prog = sag_program.record(lambda x, y: x / 3.0 + 2.0 / y)
    assert [sag_program.OPS[sag_program.decode(w)[0]] for w in prog.code] == ["mul", "recip", "mul", "add"]
    assert np.float32(1.0 / 3.0) in prog.consts
    assert ops(lambda x, y: (x > 0.1) & ~(y <= x), "b") == ["gt", "le", "not", "and"]
    assert ops(lambda x, y: torch.where(x > 0, torch.sin(x), torch.cos(y)) * torch.exp(-y)) == [
        "gt", "sin", "cos", "where", "neg", "exp", "mul"]
    # outside the set: gathers, reductions, a tensor of the card or with a derivative, a division by a tensor
    w = torch.tensor(2.0, requires_grad=True)
    for fn in (lambda x, y: x[torch.argsort(y)], lambda x, y: x * x.sum(), lambda x, y: x * w,
               lambda x, y: x / torch.tensor(2.0), lambda x, y: torch.atan2(x, y), lambda x, y: x.double()):
        assert sag_program.record(fn) is None
    # the programs give the function's values where the kernel's rounding is the CPU's
    x, y = torch.linspace(-2, 2, 101), torch.linspace(1, 3, 101)

    def fn(x, y):
        return torch.where(x > 0, x ** 2 * 0.5, -torch.abs(x)) + torch.tan(y * 0.1) - torch.log(y)
    prog = sag_program.record(fn)
    assert torch.equal(prog.replay(x, y), fn(x, y))
    assert torch.equal(sag_program.evaluate(prog, x, y), fn(x, y))
