"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, then ``setup_built`` and ``checks``); the numbers that
decided ``correct`` close standard error. Without a CUDA device, or with
fewer devices than the cell asks for, it exits with code 2 and prints no
result.
"""

import time

START = time.perf_counter()     # set-up is timed from here: before torch is imported
START_WALL = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"


def fixed_caches() -> None:
    """Every compile cache of the run at a fixed path inside the checkout,
    so that only a checkout's first run builds. The program builds its
    CUDA libraries into its own ``optrace_tpu_torch/_build``, which lies
    inside the checkout too."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    fixed_caches()
    sys.path.insert(0, str(ROOT))
    from benchmark import harness
    return harness.main(args, START, START_WALL)


if __name__ == "__main__":
    sys.exit(main())
