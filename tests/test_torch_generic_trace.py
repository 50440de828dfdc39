"""Stored traces through function and data surfaces, ray by ray against
the JAX package.

Each package builds the scene from its own classes (``generic_scene``: the
user functions take jnp on one side and torch on the other); the same
numpy bundle goes through the JAX package's ``trace_bundle`` (its scan) and
the port's on the CPU. Tolerances are those of tests/test_torch_common.py:
positions rtol 5e-6 / atol 2e-5 mm, weights atol 1e-9, INFOS equal up to
the counted budget of hit flips. The INFOS rows hold the ILL_COND count of
the generic step (rays whose bracket has no sign change).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import optrace_tpu as ot
import optrace_tpu_torch as otp
from optrace_tpu_torch.tracer import trace_core as ttc

from test_torch_common import (make_bundle, jax_trace, assert_sections_agree, generic_scene,
                               torch_trace_scene)

N = 2000


@pytest.mark.parametrize("scene,no_pol", [("cosine_lens", True), ("data_lens", False),
                                          ("data_double_gauss", True)])
def test_stored_trace_ray_by_ray(scene, no_pol):
    RTj = generic_scene(scene, ot, jnp, no_pol)
    RTt = generic_scene(scene, otp, torch, no_pol)
    bundle = make_bundle("double_gauss" if scene == "data_double_gauss" else "lens", N, seed=3)
    out_j, _ = jax_trace(RTj, bundle, no_pol, kernel=False)
    out_t, steps = torch_trace_scene(RTt, bundle, no_pol)
    assert_sections_agree(out_j, out_t, N, no_pol)
    if not no_pol:
        from test_torch_common import POL_ATOL
        keep = ~np.any((out_j["w"] > 0) != (out_t["w"].numpy() > 0), axis=1)
        np.testing.assert_allclose(out_t["pol"].numpy()[keep], out_j["pol"][keep], atol=POL_ATOL)
    kinds = [st.sfns.kind for st in steps]
    runs = ttc._partition_runs(steps, [])
    if scene == "data_double_gauss":
        # the generic first surface stays unrolled: runs on both sides of it
        assert kinds[0] == "generic" and kinds.count("generic") == 1
        assert [len(i) for k, i in runs if k == "run"] == [5, 8]
        assert runs[0] == ("step", [0])
    else:
        assert kinds[:2] == (["generic", "generic"] if scene == "cosine_lens" else ["generic", "conic"])
        assert not any(k == "run" for k, _ in runs)
    if scene == "cosine_lens":
        # the example's z bounds leave part of each face without a sign change
        ill = out_t["infos"][ttc.ILL_COND].numpy()
        assert ill[1] > 0 and ill[2] > 0


def test_entry_points_on_a_generic_scene():
    """Raytracer.trace, detector_image, the fused render and
    iterative_render run a scene with a data surface; the trace counts
    ill-conditioned rays under ILL_COND as the JAX raytracer does."""
    RT = generic_scene("data_lens", otp, torch)
    with otp.global_options.no_warnings(), otp.global_options.no_progress_bar():
        RT.trace(3000)
        assert RT.rays.p_list.shape == (3000, 4, 3)
        img = RT.detector_image()
        render, _ = otp.make_fused_render(RT, 3000, Nx=16, Ny=16,
                                          device="cpu")
        tile = render(otp.make_generator(2, "cpu"))
        RT.ITER_RAYS_STEP = 2000
        imgs = RT.iterative_render(4000)
    P = sum(rs.power for rs in RT.ray_sources)
    assert 0.8 * P < img.power() <= P
    assert 0.8 * P < float(tile[..., 3].sum()) <= P
    assert 0.8 * P < imgs[0].power() <= P

    RTc = generic_scene("cosine_lens", otp, torch)
    with otp.global_options.no_warnings(), otp.global_options.no_progress_bar():
        RTc.trace(2000)
    assert RTc._msgs[ttc.ILL_COND, 1] > 0
