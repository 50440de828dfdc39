#!/usr/bin/env python3
"""Gradient-based lens design: optimize a singlet's curvatures with torch
autograd through the full trace + detector render (the PyTorch port of
examples/lens_optimization.py).

The parameterized render (optrace_tpu_torch/tracer/diff.py) takes every
surface parameter as an input, so a spot-size loss differentiates w.r.t.
the front/back curvature. A dozen normalized-gradient steps turn a
deliberately detuned biconvex lens into a best-form singlet for its
conjugates. A step with a gradient traces through the plain PyTorch loop
(the run kernel has no backward); an evaluation without one takes the
kernels. The rays of every evaluation come from one seed, so each step
sees the same rays.
"""

import pathlib
import sys

import numpy as np
import torch

if __name__ == "__main__":      # run as a script: the packages lie one directory up
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import optrace_tpu_torch as ot  # noqa: E402
from optrace_tpu_torch.tracer.diff import make_parameterized_render, spot_loss  # noqa: E402
from examples_torch.common import capped  # noqa: E402

N_RAYS = 4096
EXT = (-2.0, 2.0, -2.0, 2.0)
SEED = 0
STEPS = 15
LR = 3e-4


def scene(device=None):
    """A deliberately detuned singlet."""
    RT = ot.Raytracer(outline=[-6, 6, -6, 6, -10, 60], no_pol=True, device=device)
    RT.add(ot.RaySource(ot.CircularSurface(r=1.5), divergence="None",
                        spectrum=ot.LightSpectrum("Monochromatic", wl=550),
                        pos=[0, 0, -5]))
    n = ot.RefractionIndex("Constant", n=1.5)
    RT.add(ot.Lens(ot.SphericalSurface(r=3, R=28.0),      # start: symmetric
                   ot.SphericalSurface(r=3, R=-28.0),     # biconvex, defocused
                   n=n, pos=[0, 0, 0], d=1.0))
    RT.add(ot.Detector(ot.RectangularSurface(dim=[4, 4]), pos=[0, 0, 25]))
    return RT


def with_rhos(params0, rhos):
    """The parameter list with the two surface curvatures replaced."""
    params = [dict(p) for p in params0]
    params[0] = dict(params[0], rho=rhos[0])
    params[1] = dict(params[1], rho=rhos[1])
    return params


def value_and_grad(loss_of_rhos, rhos):
    """The loss at ``rhos`` and its gradient with respect to them."""
    rhos = rhos.detach().requires_grad_()
    val = loss_of_rhos(rhos)
    g, = torch.autograd.grad(val, rhos)
    return val.detach(), g


def main(device=None, rays=None):
    RT = scene(device)
    render, params0 = make_parameterized_render(RT, capped(N_RAYS, rays), extent=EXT,
                                                Nx=63, Ny=63)
    loss_fn = spot_loss(render)

    def loss_of_rhos(rhos):
        """Spot RMS as a function of the two surface curvatures."""
        return loss_fn(with_rhos(params0, rhos), SEED, EXT)

    rhos = torch.stack([params0[0]["rho"], params0[1]["rho"]]).detach()
    history, radii = [], []
    for i in range(STEPS):
        val, g = value_and_grad(loss_of_rhos, rhos)
        history.append(float(val))
        # normalized-gradient step: robust to the loss's curvature scale
        rhos = rhos - LR * g / torch.clamp(torch.linalg.norm(g), min=1e-9)
        radii.append([1 / float(rhos[0]), 1 / float(rhos[1])])
    with torch.no_grad():
        history.append(float(loss_of_rhos(rhos)))
    assert history[-1] < history[0]

    # before/after spot images
    with torch.no_grad():
        img0 = render(params0, SEED)[:, :, 3].cpu().numpy()
        img1 = render(with_rhos(params0, rhos), SEED)[:, :, 3].cpu().numpy()
    return dict(rays=(STEPS + 3) * capped(N_RAYS, rays), history=history, radii=radii,
                images=[img0, img1])


def plot(results):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    history = results["history"]
    fig, axs = plt.subplots(1, 3, figsize=(12, 3.6))
    for ax, im, title in [(axs[0], results["images"][0], "start"),
                          (axs[1], results["images"][1], "optimized")]:
        ax.imshow(im, extent=EXT, origin="lower", cmap="inferno")
        ax.set_title(f"{title} spot")
        ax.set_xlabel("x / mm")
    axs[2].plot(np.arange(len(history)), 1e3 * np.asarray(history), "o-")
    axs[2].set_xlabel("step")
    axs[2].set_ylabel("spot RMS / µm")
    axs[2].set_title("convergence")
    fig.tight_layout()
    fig.savefig("lens_optimization.png", dpi=110)
    plt.close(fig)


if __name__ == "__main__":
    results = main()
    for i, (val, (R0, R1)) in enumerate(zip(results["history"], results["radii"])):
        print(f"step {i:2d}: spot RMS {val*1e3:7.2f} µm   R = {R0:+.2f} / {R1:+.2f} mm")
    print(f"spot RMS {results['history'][0]*1e3:.2f} -> {results['history'][-1]*1e3:.2f} µm")
    plot(results)
    print("saved lens_optimization.png")
