"""``RenderCheckpoint``, ``Raytracer.iterative_render`` and ``render_huge`` of
the port: the cases of tests/test_parallel.py on the CPU.

A batch is at most 20 000 rays. On the CPU every sum is taken in one fixed
order, so a resumed render equals the uninterrupted one exactly. Images of
different seeds are compared as tests/test_parallel.py compares them: total
power to 5e-3 and the correlation of a 9 × 9 irradiance grid.
"""

import numpy as np
import pytest
import torch

import optrace_tpu_torch as otp
from optrace_tpu_torch.parallel import make_fused_render, RenderCheckpoint
from optrace_tpu_torch.parallel.checkpoint import batch_seed, batch_generator

go = otp.global_options


def simple_rt():
    RT = otp.Raytracer(outline=[-5, 5, -5, 5, -10, 60], no_pol=True, device="cpu")
    RT.add(otp.RaySource(otp.CircularSurface(r=1), pos=[0, 0, -5], divergence="None",
                         spectrum=otp.LightSpectrum("Monochromatic", wl=550)))
    RT.add(otp.IdealLens(r=3, D=50, pos=[0, 0, 0]))
    RT.add(otp.Detector(otp.RectangularSurface(dim=[4, 4]), pos=[0, 0, 10]))
    return RT


def lens_rt(detector=None, **kw):
    RT = otp.Raytracer(outline=[-5, 5, -5, 5, -5, 40], device="cpu", **kw)
    RT.add(otp.RaySource(otp.CircularSurface(r=1), pos=[0, 0, 0], divergence="Lambertian",
                         div_angle=5, spectrum=otp.presets.light_spectrum.d65))
    RT.add(otp.Lens(otp.SphericalSurface(r=3, R=20), otp.SphericalSurface(r=3, R=-20),
                    n=otp.RefractionIndex("Constant", n=1.5), pos=[0, 0, 10], d=1.5))
    RT.add(detector or otp.Detector(otp.RectangularSurface(dim=[4, 4]), pos=[0, 0, 30]))
    return RT


class TestCheckpoint:

    def test_batch_generators_depend_on_seed_and_index_only(self):
        seeds = {batch_seed(s, i) for s in range(4) for i in range(50)}
        assert len(seeds) == 200 and all(0 <= v < 2 ** 63 for v in seeds)
        a = torch.rand(5, generator=batch_generator(1, 2, "cpu"))
        b = torch.rand(5, generator=RenderCheckpoint(None, 9, seed=1).generator(2, "cpu"))
        c = torch.rand(5, generator=batch_generator(1, 3, "cpu"))
        assert torch.equal(a, b) and not torch.equal(a, c)

    def test_resume_is_exact(self, tmp_path):
        RT = simple_rt()
        render, _ = make_fused_render(RT, 2048, extent=[-2, 2, -2, 2], Nx=63, Ny=63, device="cpu")
        path = str(tmp_path / "r.ckpt.npz")

        ck1 = RenderCheckpoint(str(tmp_path / "full.npz"), total_batches=6)
        for i in ck1.remaining():
            ck1.add(render(ck1.generator(i, "cpu")))
        full = ck1.image()

        ck2 = RenderCheckpoint(path, total_batches=6)
        for i in range(3):
            ck2.add(render(ck2.generator(i, "cpu")))
        ck2.save()

        ck3 = RenderCheckpoint(path, total_batches=6)
        assert ck3.done == 3 and list(ck3.remaining()) == [3, 4, 5]
        for i in ck3.remaining():
            ck3.add(render(ck3.generator(i, "cpu")))
        resumed = ck3.image()

        assert resumed.dtype == np.float64 and np.array_equal(resumed, full)
        assert resumed[:, :, 3].sum() == pytest.approx(1.0, abs=1e-3)
        np.testing.assert_allclose(ck3.image(scale=1.0), full * 6, rtol=1e-15)

    def test_mismatched_config_rejected(self, tmp_path):
        path = str(tmp_path / "r.npz")
        ck = RenderCheckpoint(path, total_batches=4)
        ck.add(np.zeros((8, 8, 4)))
        ck.save()
        with np.load(path) as d:        # the layout of the JAX package's checkpoint
            assert sorted(d.files) == ["done", "img", "seed", "total"]
            assert d["img"].dtype == np.float64 and int(d["done"]) == 1
        with pytest.raises(ValueError, match="different batch count or seed"):
            RenderCheckpoint(path, total_batches=5)
        with pytest.raises(ValueError, match="different batch count or seed"):
            RenderCheckpoint(path, total_batches=4, seed=1)
        with pytest.raises(RuntimeError, match="No batches"):
            RenderCheckpoint(None, 3).image()

    def test_render_huge_checkpoint_resume(self, tmp_path):
        """A complete checkpoint: a second call runs no batch and gives the
        same image."""
        path = str(tmp_path / "huge.ckpt.npz")
        with go.no_progress_bar():
            h1 = simple_rt().render_huge(8192, batch_size=2048, extent=[-2, 2, -2, 2],
                                         checkpoint_path=path)
            h2 = simple_rt().render_huge(8192, batch_size=2048, extent=[-2, 2, -2, 2],
                                         checkpoint_path=path)
        np.testing.assert_array_equal(h1._data, h2._data)
        assert h1.power() == pytest.approx(1.0, abs=1e-3)
        assert h1.shape == (945, 945, 4) and h1.projection is None

    def test_render_huge_interrupted_and_resumed(self, tmp_path, monkeypatch):
        """Stopped after two of four batches and resumed: exactly the
        uninterrupted render."""
        path = str(tmp_path / "cut.ckpt.npz")
        kw = dict(batch_size=2048, extent=[-2, 2, -2, 2], checkpoint_every=1)
        with go.no_progress_bar():
            full = simple_rt().render_huge(8192, **kw)
            saves = []
            real_save = RenderCheckpoint.save

            def save_then_stop(self):
                real_save(self)
                saves.append(self.done)
                if self.done == 2:
                    raise KeyboardInterrupt
            monkeypatch.setattr(RenderCheckpoint, "save", save_then_stop)
            with pytest.raises(KeyboardInterrupt):
                simple_rt().render_huge(8192, checkpoint_path=path, **kw)
            monkeypatch.setattr(RenderCheckpoint, "save", real_save)
            assert RenderCheckpoint(path, 4).done == 2 and saves == [1, 2]
            resumed = simple_rt().render_huge(8192, checkpoint_path=path, **kw)
        np.testing.assert_array_equal(resumed._data, full._data)

    def test_render_huge_arguments(self):
        RT = simple_rt()
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            RT.render_huge(1000, mesh=object())
        with pytest.raises(ValueError, match="positive int"):
            RT.render_huge(0)
        RT.remove(RT.detectors[0])
        with pytest.raises(RuntimeError, match=r"Detector\(s\) Missing"):
            RT.render_huge(1000)
        with go.no_progress_bar():
            img = simple_rt().render_huge(3000, batch_size=1000, limit=20.0)
        assert img.limit == 20.0 and img.power() == pytest.approx(1.0, abs=1e-3)
        assert np.allclose(img.extent, np.array([-2, 2, -2, 2]) + 0.054 * np.array([-1, 1, -1, 1]))


class TestFusedIterative:
    """The fused streaming path (trace sinks, no section storage) agrees
    with the stored-section path on the same scene."""

    def test_streaming_sink_matches_stored_scan(self):
        """One trace, consumed both ways: the streaming detector sink and
        the search over the stored sections agree on hit masks and weights
        exactly and on positions to one f32 rounding of the coordinate."""
        from optrace_tpu_torch.tracer.scene_compile import compile_surface
        from optrace_tpu_torch.tracer.detector import (detector_hits, build_segment_mask,
                                                       init_hit_carry, segment_update)
        from optrace_tpu_torch.tracer.trace_core import trace_bundle

        RT = lens_rt()
        N = 20000
        RT.rays.init(RT.ray_sources, N, len(RT.tracing_surfaces) + 2, RT.no_pol)
        steps = RT._build_steps()
        p, s, pols, w, wl = RT._make_source_fn(N)(otp.make_generator(7, "cpu"))
        dsurf = RT.detectors[0].surface
        sfns = compile_surface(dsurf, "cpu")
        zmin = float(dsurf.z_min)
        seg = build_segment_mask(RT._section_z_bounds(), zmin, float(dsurf.z_max))

        def sink(j, pp, pn, wp, carry):
            return segment_update(sfns, zmin, pp, pn, wp, carry) if seg[j] else carry

        out = trace_bundle(steps, RT.n0, tuple(map(float, RT.outline)), p, s, pols, w, wl,
                           RT.no_pol, RT.use_hurb, sinks=[(sink, init_hit_carry(N, "cpu"))],
                           store_sections=True)
        ph1, wsel1, ish1, done1, _ = out["sinks"][0]
        ph2, wsel2, ish2, _ = detector_hits(sfns, zmin, out["p"], out["w"], segment_mask=seg)
        assert torch.equal(ish1 & done1, ish2) and int(ish2.sum()) > N // 2
        np.testing.assert_allclose(ph1.numpy(), ph2.numpy(), atol=1e-5)
        assert torch.equal(wsel1, wsel2)

    @pytest.mark.parametrize("detector", ["flat", "spherical"])
    def test_fused_image_matches_stored_image(self, detector):
        """The fused render and ``detector_image`` of a stored trace of the
        same rays (same generator seed): the same power, and at most a few
        rays on a pixel edge in another pixel (the sink sees positions
        re-based in another frame than the stored sections)."""
        def scene():
            if detector == "flat":
                return lens_rt(), dict(), (-2.0, 2.0, -2.0, 2.0)
            det = otp.Detector(otp.SphericalSurface(r=3, R=-12), pos=[0, 0, 30])
            return lens_rt(det), dict(projection_method="Equidistant"), (-0.2, 0.2, -0.2, 0.2)
        N = 20000
        RT, kw, ext = scene()
        with go.no_warnings(), go.no_progress_bar():
            RT.trace(N)      # seeds its generator with 1
            stored = RT.detector_image(extent=list(ext), **kw)
        RT2, _, _ = scene()
        Ny, Nx, _ = stored.shape
        render, ext2 = make_fused_render(RT2, N, extent=ext, Nx=Nx, Ny=Ny, device="cpu", **kw)
        fused = render(otp.make_generator(1, "cpu")).numpy()
        assert ext2 == ext and stored.projection == kw.get("projection_method")
        sp = stored.data[:, :, 3]
        assert fused[:, :, 3].sum() == pytest.approx(sp.sum(), rel=1e-4) and sp.sum() > 0.5
        assert np.abs(fused[:, :, 3] - sp).sum() < 2e-3 * sp.sum()

    def test_iterative_render_power(self):
        RT = lens_rt()
        RT.ITER_RAYS_STEP = 20000
        with go.no_progress_bar():
            img = RT.iterative_render(60000)[0]
        assert 0.85 < img.power() < 1.0
        assert RT._msgs.shape == (5, 4)

    def test_iterative_matches_single_trace(self):
        """Batched fused accumulation converges to the one-shot image."""
        RT = lens_rt()
        RT.ITER_RAYS_STEP = 20000
        with go.no_progress_bar():
            it = RT.iterative_render(65000, extent=[-2, 2, -2, 2])[0]      # the last batch takes 25 000
            RT2 = lens_rt()
            RT2.trace(65000)
            one = RT2.detector_image(extent=[-2, 2, -2, 2])
        assert it.power() == pytest.approx(one.power(), rel=5e-3)
        a, b = it.get("Irradiance", 9).data, one.get("Irradiance", 9).data
        assert np.corrcoef(a.ravel(), b.ravel())[0, 1] > 0.995

    def test_iterative_render_multi_position(self):
        """ONE detector rendered at several positions: every fused sink
        binds its own position, not the last ``move_to``."""
        positions = [[0, 0, 22], [0, 0, 30]]
        RT = lens_rt()
        RT.ITER_RAYS_STEP = 20000
        with go.no_progress_bar():
            imgs = RT.iterative_render(60000, pos=positions, extent=[[-2, 2, -2, 2]] * 2)
        for pos, it in zip(positions, imgs):
            RT2 = lens_rt()
            RT2.detectors[0].move_to(pos)
            with go.no_progress_bar():
                RT2.trace(60000)
                one = RT2.detector_image(extent=[-2, 2, -2, 2])
            a, b = it.get("Irradiance", 9).data, one.get("Irradiance", 9).data
            assert np.corrcoef(a.ravel(), b.ravel())[0, 1] > 0.995, pos
            assert it.power() == pytest.approx(one.power(), rel=5e-3)

    def test_iterative_render_automatic_extent_limit_and_one_batch(self):
        """No extent given: the first batch's hits fix it, later batches are
        filtered to it; a limit widens the grid and is applied last; a
        count below one step is one stored trace."""
        RT = lens_rt()
        RT.ITER_RAYS_STEP = 20000
        with go.no_progress_bar():
            auto = RT.iterative_render(40000)[0]
            lim = lens_rt()
            lim.ITER_RAYS_STEP = 20000
            limited = lim.iterative_render(40000, limit=5.0)[0]
            single = lens_rt().iterative_render(5000)[0]
        assert np.all(np.abs(auto.extent) < 2.0) and auto.extent[0] < -0.3
        assert limited.limit == 5.0 and limited.extent[1] > auto._extent0[1]
        assert limited.power() == pytest.approx(auto.power(), rel=2e-2)
        assert 0.85 < single.power() < 1.0

    def test_iterative_render_hurb_and_filter(self):
        """Every step kind through the fused batches: the generator of a
        batch feeds the sources and then the HURB steps."""
        from tests.test_torch_steps import steps_scene
        def scene():     # a wider cone than the lenses take: rays that miss are counted
            RT = steps_scene(otp, no_pol=True, use_hurb=True, device="cpu")
            RT.ray_sources[0].div_angle = 25.0
            return RT
        RT = scene()
        RT.ITER_RAYS_STEP = 10000
        with go.no_progress_bar(), go.no_warnings():
            img = RT.iterative_render(30000, extent=[-4, 4, -4, 4])[0]
        assert 0.02 < img.power() < 0.9 and np.isfinite(img.data).all()
        # INFOS are summed over the batches: three times those of one batch, to noise
        one = scene()
        with go.no_progress_bar(), go.no_warnings():
            one.trace(10000)
        assert RT._msgs.shape == one._msgs.shape and one._msgs.sum() > 500
        assert RT._msgs.sum() == pytest.approx(3 * one._msgs.sum(), rel=0.1)

    @pytest.mark.parametrize("case", ["no_source", "no_detector", "n", "detector_index", "limit",
                                      "projection_method", "extent", "index_without_pos"])
    def test_iterative_render_argument_checks(self, case):
        RT = lens_rt()
        two = [[0, 0, 22], [0, 0, 30]]
        if case == "no_source":
            RT.remove(RT.ray_sources[0])
            exc, msg, call = RuntimeError, r"Ray Source\(s\) Missing", lambda: RT.iterative_render(100)
        elif case == "no_detector":
            RT.remove(RT.detectors[0])
            exc, msg, call = RuntimeError, r"Detector\(s\) Missing", lambda: RT.iterative_render(100)
        elif case == "n":
            exc, msg, call = ValueError, "positive int", lambda: RT.iterative_render(0)
        elif case == "index_without_pos":
            exc, msg = ValueError, "detector_index list"
            call = lambda: RT.iterative_render(100, detector_index=[0, 0])      # noqa: E731
        else:
            exc, msg = ValueError, f"{case} list needs to have the same length as pos list"
            bad = dict(detector_index=[0], limit=[1.0], projection_method=["Equidistant"],
                       extent=[[-1, 1, -1, 1]])[case]
            call = lambda: RT.iterative_render(100, pos=two, **{case: bad})     # noqa: E731
        with pytest.raises(exc, match=msg):
            call()
