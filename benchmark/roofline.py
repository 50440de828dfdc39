"""The yardstick of the kernels' roofline shares: the card's peaks and the
operations and bytes that a cell's problem needs, counted from its scene,
its rays and its image, never from the launches the program makes. A
later change that fuses, splits or rewrites a kernel is measured against
the same counts.

The constants are those of the program's own on-card check
(``chip_smoke.py``), copied here so that the yardstick lies with the
benchmark.
"""

import torch

from . import reference

# one NVIDIA H100 SXM, data sheet, dense rates, at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations of one step for one ray alive when it reaches it, by step
# kind: a conic (sphere, flat) refraction is hit solve, clamp, normal, Snell
# and Fresnel, outline test
RUN_OPS_PER_RAY_STEP = {"conic": 150, "flat": 150, "tilted": 150,
                        "asphere": 150 + 42 * 22 + 40 * 15,
                        "absorb:circle": 60, "absorb:ring": 60, "absorb:rect": 60,
                        "absorb:slit": 60}
BIN_OPS_PER_RAY = 30
RUN_MIN = 4             # refractions in a row that make a run of kernel 1
STATE_BYTES = 28        # a ray's position, direction and weight, f32
POL_BYTES = 12
SECTION_BYTES = 16      # a stored section: position and weight; with polarization 28
BIN_BYTES_PER_RAY = 16  # x, y, weight, wavelength in
PIXEL_BYTES = 16        # X, Y, Z, W out


def runs(scene: reference.Scene) -> list:
    """The runs of kernel 1 that the scene defines: the indices of
    ``RUN_MIN`` or more refracting surfaces in a row, no stop between."""
    out, cur = [], []
    for i, s in enumerate(scene.surfaces):
        if s["kind"] == "refract":
            cur.append(i)
            continue
        if len(cur) >= RUN_MIN:
            out.append(cur)
        cur = []
    if len(cur) >= RUN_MIN:
        out.append(cur)
    return out


def kernel1_work(scene: reference.Scene, N: int, alive: list, pol: bool, store: bool) -> tuple:
    """(operations, bytes) of tracing N rays through the scene's runs:
    ``alive[i]`` is the share of rays alive when they reach surface i. Each
    run reads and writes the ray state once, reads each medium's index once
    a ray, and writes the sections that a stored trace keeps."""
    ops = nbytes = 0.0
    state = STATE_BYTES + (POL_BYTES if pol else 0)
    for run in runs(scene):
        media = {name for i in run for name in scene.surfaces[i]["media"]}
        nbytes += N * (2 * state + 4 * len(media)) + len(run) * 16
        if store:
            nbytes += N * len(run) * (SECTION_BYTES + (POL_BYTES if pol else 0))
        ops += sum(alive[i] * N * RUN_OPS_PER_RAY_STEP["conic"] for i in run)
    return ops, nbytes


def kernel2_work(n_hits: float, Nx: int, Ny: int) -> tuple:
    """(operations, bytes) of binning ``n_hits`` hits into an Nx × Ny XYZW
    image: 16 B a hit in, the image out once."""
    return n_hits * BIN_OPS_PER_RAY, n_hits * BIN_BYTES_PER_RAY + Nx * Ny * PIXEL_BYTES


def least_seconds(ops: float, nbytes: float) -> float:
    return max(ops / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


_SHARES = {}


def shares(cfg: dict, seed: int, device, n: int = 200_000) -> dict:
    """What the scene does to its rays, from a reference trace of ``n``
    rays: ``alive`` (the share alive on reaching each surface) and ``hits``
    (the share that hits the detector)."""
    key = (id(cfg), seed, str(device))
    if key not in _SHARES:
        scene = reference.Scene(cfg)
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed) + 1)
        with torch.no_grad():
            p, s, _, w, wl = reference.sample_rays(scene, n, gen, seed)
            tr = reference.trace(scene, p, s, None, w, wl)
            alive = [float((tr["w"][:, j] > 0).double().mean()) for j in range(len(scene.surfaces))]
            _, _, wh = reference.detector_hits(scene, *tr["last"], tr["end"])
        _SHARES[key] = dict(alive=alive, hits=float((wh > 0).double().mean()))
    return _SHARES[key]
