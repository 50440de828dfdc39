"""The prepared run of the port's run kernel: the step table is built once
for a step list, not once a launch, and never outlives its steps.

``ops/cuda_run.py:PreparedRun`` holds what a launch needs of a run and what
does not depend on the rays; ``tracer/trace_core.py:RunPlans`` keeps the
prepared runs of one step list. These tests count the calls of
``cuda_run._step_table`` on the CPU, where the wrapper takes the plain
version but the dispatch prepares its runs all the same.
"""

import numpy as np
import pytest
import torch

import optrace_tpu_torch as otp
from optrace_tpu_torch.ops import cuda_run
from optrace_tpu_torch.ops.cuda_run import PreparedRun
from optrace_tpu_torch.presets.geometry import double_gauss
from optrace_tpu_torch.tracer import trace_core as ttc

OUTLINE = [-150, 150, -150, 150, -50001, 180]
SRC = dict(divergence="Isotropic", orientation="Converging", conv_pos=[0, 0, 0],
           div_angle=0.03, pos=[0, 0, -50000])


def _scene():
    RT = otp.Raytracer(outline=OUTLINE, no_pol=True, device="cpu")
    RT.add(otp.RaySource(otp.Point(), spectrum=otp.LightSpectrum("Constant"), **SRC))
    RT.add(double_gauss())
    return RT


@pytest.fixture
def table_calls(monkeypatch):
    """Counts the calls of ``_step_table`` and keeps the tables it made."""
    made = []
    real = cuda_run._step_table

    def counting(steps, med_idx):
        tab = real(steps, med_idx)
        made.append(tab)
        return tab
    monkeypatch.setattr(cuda_run, "_step_table", counting)
    return made


@pytest.fixture
def quiet():
    with otp.global_options.no_warnings(), otp.global_options.no_progress_bar():
        yield


def test_two_traces_build_the_table_once(table_calls, quiet):
    """The double Gauss has runs of 6 and 8: two tables at the first trace,
    none at the second."""
    RT = _scene()
    RT.trace(2000)
    assert [t.shape[0] for t in table_calls] == [6, 8]
    w1 = RT.rays.w_list.copy()
    RT.trace(2000)
    assert len(table_calls) == 2
    assert RT.rays.w_list.shape == w1.shape and not np.array_equal(RT.rays.w_list, w1)  # other seed


def test_moving_a_lens_builds_a_new_table(table_calls, quiet):
    """A moved lens is another scene: new steps, new plans, and the new
    table holds the new frame shifts."""
    RT = _scene()
    RT.trace(2000)
    first = [t.copy() for t in table_calls]
    steps_before = RT._trace_entry(2000).program.steps
    lens = RT.lenses[2]
    lens.move_to(lens.pos + np.array([0.0, 0.0, 0.25]))
    RT.trace(2000)
    assert len(table_calls) == 4 and RT._trace_entry(2000).program.steps is not steps_before
    second = table_calls[2:]
    # dz (word 2) of the moved lens' front surface and of the surface behind it
    moved = [not np.array_equal(a[:, :6], b[:, :6]) for a, b in zip(first, second)]
    assert any(moved), "the new table carries the old frame chain"
    dz_old = np.concatenate([t[:, 2] for t in first])
    dz_new = np.concatenate([t[:, 2] for t in second])
    assert np.isclose(np.abs(dz_new - dz_old).max(), 0.25, atol=1e-5)
    RT.trace(2000)
    assert len(table_calls) == 4


def test_another_outline_or_another_lens_object_is_another_scene(table_calls, quiet):
    RT = _scene()
    RT.trace(1000)
    RT.outline = [-150, 150, -150, 150, -50001, 190]
    RT.trace(1000)
    assert len(table_calls) == 4
    out = np.concatenate([t[:, 17:23] for t in table_calls[2:]])
    old = np.concatenate([t[:, 17:23] for t in table_calls[:2]])
    assert np.allclose(out[:, 5] - old[:, 5], 10.0, atol=1e-4)
    # the same lens data in a new object: the kept steps are not trusted
    old_lens = RT.lenses[-1]
    RT.remove(old_lens)
    RT.add(old_lens.copy())
    RT.trace(1000)
    assert len(table_calls) == 6


def test_fused_render_prepares_once_for_all_batches(table_calls):
    RT = _scene()
    render, _ = otp.make_fused_render(RT, 2000, Nx=63, Ny=63, device="cpu")
    imgs = [render(otp.make_generator(b, "cpu")) for b in range(3)]
    assert len(table_calls) == 2
    assert all(bool(torch.isfinite(i).all()) and float(i[..., 3].sum()) > 0 for i in imgs)
    otp.make_fused_render(RT, 2000, Nx=63, Ny=63, device="cpu")[0](otp.make_generator(0, "cpu"))
    assert len(table_calls) == 4        # a new render compiles new steps and prepares anew


def test_plans_belong_to_one_step_list():
    """The rule that makes a prepared run stale is new steps: plans made
    for one list refuse another, and within a list the partition (here
    changed by ``cuda_fuse_planar``) selects its own plan."""
    RT = _scene()
    steps = RT._build_steps()
    plans = ttc.RunPlans(steps)
    gen = otp.make_generator(1, "cpu")
    RT.rays.init(RT.ray_sources, 500, len(RT.tracing_surfaces) + 2, True)
    bundle = RT._make_source_fn(500)(gen)
    outline = tuple(float(v) for v in RT.outline)
    out = ttc.trace_bundle(steps, RT.n0, outline, *bundle, True, plans=plans)
    assert len(plans) == 2
    ttc.trace_bundle(steps, RT.n0, outline, *bundle, True, plans=plans)
    assert len(plans) == 2
    otp.global_options.cuda_fuse_planar = True
    try:
        fused = ttc.trace_bundle(steps, RT.n0, outline, *bundle, True, plans=plans)
    finally:
        otp.global_options.cuda_fuse_planar = False
    assert len(plans) == 3 and sorted(p.L for p in plans._plans.values()) == [6, 8, 15]
    assert torch.equal(fused["w"], out["w"])
    with pytest.raises(ValueError, match="another step list"):
        ttc.trace_bundle(RT._build_steps(), RT.n0, outline, *bundle, True, plans=plans)
    # without plans every call prepares for itself and gives the same sections
    again = ttc.trace_bundle(RT._build_steps(), RT.n0, outline, *bundle, True)
    assert torch.equal(again["p"], out["p"]) and torch.equal(again["w"], out["w"])


def _const(**kw):
    c = dict(rho=0.05, k=-0.5, r=2.5, z_min=0.0, z_max=0.2, is_flat=False, kind="conic",
             dx=0.0, dy=0.0, dz=0.0, ox=0.0, oy=0.0, oz=0.0,
             out=(-100.0, 100.0, -100.0, 100.0, -100.0, 100.0))
    c.update(kw)
    return c


def test_prepared_run_holds_what_a_launch_needs():
    steps = [_const(), _const(is_flat=True, kind="circle"), _const(kind="asphere", coeff=(1e-4, 2e-6))]
    plan = PreparedRun(steps, [(0, 1), (1, 0), (0, 2)])
    assert plan.L == 3 and plan.rows == (0, 2) and plan.all_kinds
    assert plan.tags == {"conic", "flat", "asphere"}
    assert len(plan.raw) == 4 * (3 * cuda_run.STEP_WORDS + 4)
    assert plan.raw == cuda_run._table_bytes(steps, [(0, 1), (1, 0), (0, 2)])
    small = PreparedRun(steps[:2], [(0, 1), (1, 0)])
    assert not small.all_kinds and small.tags == {"conic", "flat"}
    # the wrapper takes a plan in place of preparing, also on CPU tensors
    p = torch.zeros((8, 3))
    p[:, 2] = -1.0
    s = torch.tensor([[0.0, 0.0, 1.0]]).repeat(8, 1)
    n_tab = torch.stack([torch.ones(8), torch.full((8,), 1.5), torch.full((8,), 1.6)])
    a = cuda_run.conic_run(p, s, torch.ones(8), n_tab, plan.med_idx, plan.steps, plan=plan)
    b = cuda_run.conic_run_reference(p, s, torch.ones(8), n_tab, plan.med_idx, plan.steps)
    assert torch.equal(a[0][0], b[0][0]) and torch.equal(a[1][0], b[1][0])


@pytest.mark.parametrize("case", ["too_many_steps", "too_many_coefficients", "pairs", "kind", "empty"])
def test_a_run_that_does_not_fit_is_refused(case):
    """Over the limit means an error at preparation, never a cut table."""
    if case == "too_many_steps":
        n = cuda_run.MAX_RUN + 1
        with pytest.raises(ValueError, match="a run holds 1 to"):
            PreparedRun([_const()] * n, [(0, 1)] * n)
    elif case == "too_many_coefficients":
        many = [_const(kind="asphere", coeff=tuple([1e-9] * 40))] * 200
        with pytest.raises(ValueError, match="shared memory"):
            PreparedRun(many, [(0, 1)] * 200)
    elif case == "pairs":
        with pytest.raises(ValueError, match="one .* pair per step"):
            PreparedRun([_const()] * 3, [(0, 1)] * 2)
    elif case == "kind":
        with pytest.raises(NotImplementedError, match="not ported"):
            PreparedRun([_const(kind="generic")], [(0, 1)])
    else:
        with pytest.raises(ValueError, match="a run holds 1 to"):
            PreparedRun([], [])
