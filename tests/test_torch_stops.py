"""Fused aperture absorbers: a stop between lens groups as a step of the run,
against the JAX package's run kernel (interpret mode) and against the
port's own unrolled absorb step, and the partition's treatment of
absorbers. Scenes, helpers and tolerances are those of
tests/test_torch_scenes.py.
"""

import numpy as np
import pytest
import torch

import optrace_tpu as ot
import optrace_tpu_torch as otp
from optrace_tpu_torch.tracer import trace_core as ttc

from tests.test_torch_common import make_bundle, jax_trace, W_RTOL
from tests.test_torch_scenes import (build_stop, port_trace, run_lengths, assert_agree, fuse_planar,  # noqa: F401
                                     P_RTOL_K, P_ATOL_THROW_K, W_ATOL_K)


@pytest.mark.parametrize("no_pol", [True, False], ids=["nopol", "pol"])
@pytest.mark.parametrize("stop", ["ring", "slit", "circle"])
def test_aperture_fused_scene_parity(fuse_planar, stop, no_pol):
    """A stop between lens groups joins the run as a fused absorb step; the
    stored n of the stop's section is the glass around it."""
    N = 20000
    bundle = make_bundle("build", N, seed=25)
    out_j, _ = jax_trace(build_stop(ot, no_pol, stop), bundle, no_pol, kernel=True)
    RT_t = build_stop(otp, no_pol, stop, device="cpu")
    out_t, steps = port_trace(RT_t, bundle, no_pol)
    assert run_lengths(steps) == [5] and steps[2].action == "absorb"
    assert_agree(out_j, out_t, N, no_pol)
    assert float(out_t["n"][:, 3].mean()) > 1.4        # ambient at the stop is the glass
    absorbed = (out_t["w"][:, 2] > 0) & (out_t["w"][:, 3] == 0)
    assert 0 < int(absorbed.sum()) < N


def test_fused_stop_equals_unrolled_stop():
    """The port's fused absorber against the port's own unrolled absorb
    step (flag off): same sections, same n, same INFOS."""
    N = 20000
    bundle = make_bundle("build", N, seed=26)
    out_u, steps_u = port_trace(build_stop(otp, device="cpu"), bundle, True)
    assert run_lengths(steps_u) == []
    otp.global_options.cuda_fuse_planar = True
    try:
        out_f, steps_f = port_trace(build_stop(otp, device="cpu"), bundle, True)
        assert run_lengths(steps_f) == [5]
    finally:
        otp.global_options.cuda_fuse_planar = False
    np.testing.assert_allclose(out_f["p"].numpy(), out_u["p"].numpy(), rtol=P_RTOL_K, atol=P_ATOL_THROW_K)
    np.testing.assert_allclose(out_f["w"].numpy(), out_u["w"].numpy(), rtol=W_RTOL, atol=W_ATOL_K)
    assert torch.equal(out_f["n"], out_u["n"])
    assert torch.equal(out_f["infos"], out_u["infos"])


def test_partition_trims_absorbers_and_respects_hurb():
    """Absorbers at the edges of a run are trimmed; an aperture with HURB
    is fused only while HURB is off."""
    otp.global_options.cuda_fuse_planar = True
    try:
        RT = build_stop(otp, device="cpu")
        RT.add(otp.Aperture(otp.RingSurface(r=3, ri=2.5), pos=[0, 0, 20]))
        steps = RT._build_steps()
        part = ttc._partition_runs(steps, [])
        assert part == [("run", [0, 1, 2, 3, 4]), ("step", [5]), ("step", [6])]
        assert steps[2].hurb and ttc._run_step(steps[2], use_hurb=False)
        assert not ttc._run_step(steps[2], use_hurb=True)
        assert [k for k, _ in ttc._partition_runs(steps, [], use_hurb=True)] == ["step"] * 7
        # a sink that consumes a segment keeps its step out of a run
        mask = [False] * 7
        mask[3] = True
        assert ttc._partition_runs(steps, [mask])[:4] == [("step", [0]), ("step", [1]),
                                                          ("step", [2]), ("step", [3])]
    finally:
        otp.global_options.cuda_fuse_planar = False
