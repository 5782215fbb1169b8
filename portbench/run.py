"""Run one cell of the benchmark once, on the card this machine holds.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Prints one JSON line last on standard output: correct, attempted,
failed, metrics (the cell's end-to-end metrics, or with --trace 1 its
per-layer ones), device, with --trace 1 a breakdown, and last the
numbers compared with their limits, which also end standard error.
Exits 1, printing no result, without a CUDA device, when the program
cannot be imported, or when jax, jaxlib, flax or the JAX package is
loaded once the window has closed.  Kernel builds and caches stay in
the checkout's build/.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'yulio_raytracer_tpu')
THREADS = '4'


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is a forbidden one, compared
    whole (yulio_raytracer_tpu_torch is not yulio_raytracer_tpu)."""
    return sorted({m.split('.')[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog='portbench/run.py')
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for k in ('OMP_NUM_THREADS', 'MKL_NUM_THREADS', 'OPENBLAS_NUM_THREADS'):
        os.environ[k] = THREADS
    build = os.path.join(ROOT, 'build')
    os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(build, 'torch_extensions')
    os.environ['TRITON_CACHE_DIR'] = os.path.join(build, 'triton')
    sys.path.insert(0, ROOT)
    import torch
    from portbench import harness, spec

    spec.cell(args.workload)
    chips = next(w['chips'] for w in spec.benchmark()['workloads']
                 if w['name'] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    try:
        import yulio_raytracer_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the program is missing: {e}", file=sys.stderr)
        return 1
    torch.set_num_threads(int(THREADS))
    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), t0=T0)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 1
    lat = sorted(out.pop('latencies_s'))
    print(f"window: {len(lat)} frames, latency ms min {lat[0] * 1e3:.2f} "
          f"median {lat[len(lat) // 2] * 1e3:.2f} max {lat[-1] * 1e3:.2f}; "
          f"check {out['check_s']:.2f} s", file=sys.stderr)
    for k, v in out['compared'].items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
