"""The benchmark of the PyTorch port (nerftex_torch) on one CUDA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of BENCHMARK.json once, from the root of a checkout: it
builds the cell's program from its configuration file, with weights (and
data) made from the seed, warms up every shape the cell uses, measures
for ``--seconds`` (with ``--trace 1``: its traced stretches instead),
checks the answers against the plain reference in benchmark/reference,
and prints one JSON line last on standard output:

    {"correct", "attempted", "failed", "metrics", "device",
     ["breakdown",] "checks"}

``metrics`` holds the cell's end-to-end metrics, or with ``--trace 1``
its per-layer metrics.  ``checks`` holds each number compared with its
limit; the same go to the last lines of standard error.  ``--control 1``
puts the reference in TF32 in the program's place in the comparison (the
lower-precision control), which must come out not correct.

Without a CUDA card, or with fewer cards than the cell asks for, or with
any JAX module loaded once the window has closed, it prints no result and
exits non-zero.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Kernel caches stay inside the checkout, at fixed paths.
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "benchmark", ".cache", "torch")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "benchmark", ".cache", "triton")
os.environ["USE_FLAX"] = "0"
# One process, one compute thread: the host-bound loops gain nothing from a
# pool of workers, which would compete with the main thread for the cores.
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"
sys.path.insert(0, ROOT)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
    from benchmark.harness import cell as cell_run

    manifest_cell = cell_run.find(args.workload)
    need = int(manifest_cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"benchmark: needs {need} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = cell_run.run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                          START, control=bool(args.control))
    from benchmark.harness.imports import forbidden_loaded

    bad = forbidden_loaded()
    if bad:
        print(f"benchmark: JAX modules loaded in this process: {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
