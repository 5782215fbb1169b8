"""Readings for the limits of `correct`: the program's numbers over many
seeds, and the control's (the reference in bfloat16 in the program's
place), at the cell's own size, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3
        [--control-seeds 4,5,6] [--seconds 4]

One JSON line a run on standard output and in
chiprun_out/calibrate_<cell>.jsonl: the seed, program or control, the
numbers compared, the refinements or frames, set-up and check seconds.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog='portbench/calibrate.py')
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', default='')
    ap.add_argument('--control-seeds', default='')
    ap.add_argument('--seconds', type=float, default=4.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from portbench import harness
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 1
    out_dir = os.path.join(ROOT, 'chiprun_out')
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f'calibrate_{args.workload}.jsonl')
    runs = [(int(s), False) for s in args.seeds.split(',') if s]
    runs += [(int(s), True) for s in args.control_seeds.split(',') if s]
    with open(path, 'a') as f:
        for seed, control in runs:
            t0 = time.perf_counter()
            r = harness.run(args.workload, seed, args.seconds, False,
                            control=control, t0=t0)
            line = json.dumps({
                'workload': args.workload, 'seed': seed,
                'side': 'control' if control else 'program',
                'correct': r['correct'], 'attempted': r['attempted'],
                'numbers': {k: v['value'] for k, v in r['compared'].items()},
                'metrics': {k: v['value'] for k, v in r['metrics'].items()},
                'check_s': r['check_s'],
                'peak_bytes': r['device']['memory_peak_bytes'],
                'card': r['device']['kind']})
            print(line, flush=True)
            f.write(line + '\n')
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
