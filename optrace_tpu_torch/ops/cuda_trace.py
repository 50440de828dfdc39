"""Single-step trace kernel: one fused no-pol conic hit-and-refract step.

Counterpart of ``optrace_tpu/ops/pallas_trace.py``: :func:`conic_step`
stands for ``conic_step_pallas`` and launches the kernel of
``csrc/conic_step.cu``; :func:`conic_step_reference`, its plain PyTorch
version, stands for ``conic_step_xla``. Both are the step function of the
whole-run kernel (``csrc/trace_step.cuh``, ``ops/cuda_run.py:_one_step``) in
its single-step form: no frame shift, per-ray ``n1`` and ``n2``, aperture
test ``r² <= r_ap·r_ap`` without N_EPS, no miss kill, no outline box and no
counts. The kernel's source carries the design note and the bound.

The step is a probe: nothing on the trace's path calls it, as nothing in the
JAX package calls its TPU counterpart outside the probe and its test.
"""

import ctypes

import torch

from . import cuda_run


def _consts(rho, k, z_min_rel, z_max_rel, r_ap) -> dict:
    """The step's constant dict in the form of ``cuda_run._one_step``; the
    frame, origin and outline entries only fill the table's unused words."""
    return dict(kind="conic", is_flat=False, single=True, rho=float(rho), k=float(k),
                r=float(r_ap), z_min=float(z_min_rel), z_max=float(z_max_rel),
                dx=0.0, dy=0.0, dz=0.0, ox=0.0, oy=0.0, oz=0.0, out=(0.0,) * 6)


def conic_step_reference(p, s, w, n1, n2, *, rho, k, z_min_rel, z_max_rel, r_ap):
    """Plain PyTorch version of :func:`conic_step`: same arguments, same
    results, any device, f32 or f64, differentiable."""
    c = _consts(rho, k, z_min_rel, z_max_rel, r_ap)
    st, _, _ = cuda_run._one_step(p[:, 0], p[:, 1], p[:, 2], s[:, 0], s[:, 1], s[:, 2],
                                  w, n1, n2, c)
    return torch.stack(st[0:3], dim=-1), torch.stack(st[3:6], dim=-1), st[6]


def _lib():
    from . import _build
    lib = _build.load("conic_step")
    if not getattr(lib, "_ot_ready", False):
        vp = ctypes.c_void_p
        lib.conic_step_launch.argtypes = [vp, vp, vp, vp, vp, vp, ctypes.c_longlong,
                                          vp, vp, vp, vp]
        lib.conic_step_launch.restype = ctypes.c_int
        lib.conic_step_step_bytes.restype = ctypes.c_int
        if lib.conic_step_step_bytes() != 4 * cuda_run.STEP_WORDS:
            raise RuntimeError("Step layout of csrc/trace_step.cuh and STEP_WORDS disagree")
        lib._ot_ready = True
    return lib


def conic_step(p, s, w, n1, n2, *, rho, k, z_min_rel, z_max_rel, r_ap):
    """One conic hit-and-refract step for every ray, without polarization.

    On CUDA tensors this launches the kernel (or raises); tensors on the
    CPU take the plain version :func:`conic_step_reference`.

    :param p, s: (N, 3) positions relative to the surface vertex, directions
    :param w, n1, n2: (N,) weights and refractive indices before and after
    :param rho, k: curvature 1/R and conic constant
    :param z_min_rel, z_max_rel: z-extent of the surface
    :param r_ap: aperture radius
    :return: (p', s', w')
    """
    if p.device.type == "cpu":
        return conic_step_reference(p, s, w, n1, n2, rho=rho, k=k, z_min_rel=z_min_rel,
                                    z_max_rel=z_max_rel, r_ap=r_ap)
    if p.device.type != "cuda":
        raise ValueError(f"conic_step runs on CUDA or CPU tensors, not on {p.device}")

    N, dev = p.shape[0], p.device
    cuda_run._check("p", p, (N, 3), dev)
    cuda_run._check("s", s, (N, 3), dev)
    for name, t in (("w", w), ("n1", n1), ("n2", n2)):
        cuda_run._check(name, t, (N,), dev)
    p, s, w, n1, n2 = (t.contiguous() for t in (p, s, w, n1, n2))

    step = cuda_run._step_table([_consts(rho, k, z_min_rel, z_max_rel, r_ap)], [(0, 0)])
    lib = _lib()
    with torch.cuda.device(dev):
        p2, s2, w2 = torch.empty_like(p), torch.empty_like(s), torch.empty_like(w)
        rc = lib.conic_step_launch(
            step.ctypes.data, p.data_ptr(), s.data_ptr(), w.data_ptr(), n1.data_ptr(),
            n2.data_ptr(), N, p2.data_ptr(), s2.data_ptr(), w2.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"conic_step kernel launch failed with CUDA error {rc}")
    conic_step.launches += 1
    return p2, s2, w2


conic_step.launches = 0             # kernel launches since the last reset


def reset_launch_counts() -> None:
    conic_step.launches = 0
