"""The benchmark of ``torchsnapshot_tpu_torch`` on NVIDIA GPUs.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell is looked up in ``BENCHMARK.json``;
its configuration, traffic mix and metric readers are files under
``portbench/`` found by name (``lib/cells.py``). The last line of standard
output is the result: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
metrics), ``device`` and, traced, ``breakdown``; then ``checks``, each
number compared with the plain reference beside its limit. Earlier lines,
prefixed ``portbench``, log the card, its power limit and clocks, the
host's CPUs and ``MemAvailable``, and the port's kernel launches.

Without the CUDA devices the cell asks for, or if JAX or the JAX package
was loaded, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Build and kernel caches of torch and Triton, at fixed paths inside the
# checkout, so that only the first run of a cell in a checkout builds.
CACHE = os.path.join(ROOT, ".portbench_cache")


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def prepare_environment() -> None:
    """Caches inside the checkout, before torch or the port is imported.
    The port runs at its default settings."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    args = parse(argv)
    # The script's own folder would shadow top-level modules by the names
    # of the benchmark's folders; the checkout's root takes its place.
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    prepare_environment()
    from portbench.lib import harness

    return harness.main(args)


if __name__ == "__main__":
    sys.exit(main())
