"""The example scripts of ``examples/``, ported to ``optrace_tpu_torch``.

Each script has the file name of its JAX counterpart and three parts:

- ``main(device=None, rays=None)`` builds the scene and computes the
  results: the numbers the JAX example prints, and the images its plots
  show. ``device=None`` is the CUDA device (it raises without one);
  ``device="cpu"`` runs on the CPU. ``rays=None`` keeps the example's own
  ray counts; an integer caps every trace, iterative render and design
  render at that many rays, and an iterative render keeps its number of
  batches.
- ``plot(results)`` imports matplotlib (through ``optrace_tpu_torch.plots``)
  and writes the PNG files of the JAX example into the working directory.
- ``python3 examples_torch/<name>.py`` calls both.

Importing a script builds nothing and needs no matplotlib.
"""
