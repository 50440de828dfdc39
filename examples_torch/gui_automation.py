#!/usr/bin/env python3
"""GUI automation: vary the position and size of a line source and update
the scene after each step (the PyTorch port of examples/gui_automation.py).
The automation function is rerunnable through a custom button in the GUI.
It writes no image: ``main`` returns the open ``TraceGUI`` under ``"sim"``,
and the caller closes it."""

import pathlib
import sys

import numpy as np

if __name__ == "__main__":      # run as a script: the packages lie one directory up
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import optrace_tpu_torch as ot  # noqa: E402
from examples_torch.common import capped  # noqa: E402

# keep the demo fast when executed by the test suite
SLEEPING_TIME = 0.0


def automated(GUI):
    """the thing to automate"""
    import time

    RT = GUI.raytracer

    # change settings (these could also be set when initializing TraceGUI())
    GUI.minimalistic_view = True
    GUI.hide_labels = True

    # zoom in to the relevant part
    GUI.set_camera(center=[0, 0, 4], height=10)

    # GUI properties were set, but the changes need to be processed
    GUI.process()

    # default state, needed to rerun this function
    with GUI.smart_replot():
        RT.ray_sources[0].set_surface(ot.Line(r=1, angle=90))
        RT.ray_sources[0].move_to([0, 0, -15])

    # vary the lateral source position
    for yp in np.linspace(1, 4, 4):
        with GUI.smart_replot():
            time.sleep(SLEEPING_TIME)
            RT.ray_sources[0].move_to([0, yp, -15])

    # reset
    RT.ray_sources[0].move_to([0, 0, -15])

    # vary the source size
    for ri in np.linspace(0.5, 5, 5):
        with GUI.smart_replot():
            time.sleep(SLEEPING_TIME)
            RT.ray_sources[0].set_surface(ot.Line(r=ri, angle=90))


def main(device=None, rays=None):
    from optrace_tpu_torch.gui import TraceGUI

    RT = ot.Raytracer(outline=[-10, 10, -10, 10, -25, 40], device=device)

    # line source emitting parallel white light
    RS0 = ot.RaySource(ot.Line(r=1, angle=90), divergence="None",
                       spectrum=ot.presets.light_spectrum.d65,
                       pos=[0, 0, -10], s=[0, 0, 1])
    RT.add(RS0)

    # a sphere lens with R=5
    n = ot.RefractionIndex("Constant", n=1.3)
    front = ot.SphericalSurface(r=4.99999999, R=5)
    back = ot.SphericalSurface(r=4.99999999, R=-5)
    RT.add(ot.Lens(front, back, d=10, pos=[0, 0, 0], n=n))

    # the automation function runs synchronously, as user input would
    N = capped(20000, rays)
    sim = TraceGUI(RT, ray_count=N)
    sim.add_custom_button("Rerun", lambda: automated(sim))
    sim.control(func=automated, args=(sim,))

    # the custom button is a real rendered matplotlib widget; fire it through
    # a synthetic canvas click, exactly like a user pressing it in the panel
    assert "custom_button:Rerun" in sim.panel.widgets
    sim.scene.fig.canvas.draw()
    sim.panel.click_button("Rerun")

    # the keyboard layer works the same way: toggle high contrast and back
    sim.shortcuts.press("c")
    sim.shortcuts.press("c")
    return dict(ray_count=N, rays_traced=int(RT.rays.N), source_r=float(RT.ray_sources[0].surface.r),
                rays_current=bool(RT.check_if_rays_are_current()), sim=sim)


if __name__ == "__main__":
    main()
