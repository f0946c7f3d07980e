"""The readings that the limits of a cell's comparison are set from.

    python3 bench_cuda/control.py --workload <cell> --seeds 1,2,3 \
        --int8-seeds 4,5,6 --fp8-seeds 7,8,9 --seconds 3

Each seed is one run of the cell as the benchmark runs it (in this process,
untraced, ``--seconds`` long), and its compared numbers are one reading.
``--seeds`` runs the program as the configuration states it: readings of
the sound program. The controls run in the program's place, through the
same window and comparison: ``int8`` is the program's own int8 path
(``builder.int8_forward``), ``fp8`` the reference with every product's
operands in fp8 (``builder.fp8_forward``). Each limit lies between the
largest sound reading and the smallest reading of either control (PERF.md
gives the readings). One line a reading on standard output, then a JSON
summary line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONTROLS = {"int8": "int8_forward", "fp8": "fp8_forward"}
KEYS = ("logp_err_median", "logp_err_p99", "top1_outside_ref_top5")


def reading(workload: str, seed: int, seconds: float, device,
            entry: str = "offline_forward") -> dict:
    """The compared numbers of one run of ``workload`` with the timed
    forward made by the builder's ``entry``, and whether it was correct."""
    from bench_cuda import harness as H

    r = H.run_cell(ROOT, workload, seed, seconds, False, device, H.now(),
                   entry=entry)
    got = {k: v[0] for k, v in r["checks"].items()}
    got["correct"] = r["correct"]
    return got


def seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--int8-seeds", default="")
    p.add_argument("--fp8-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from bench_cuda import harness as H

    device = torch.device("cuda", 0)
    runs = [("sound", s, "offline_forward") for s in seeds(args.seeds)]
    runs += [(name, s, CONTROLS[name]) for name in CONTROLS
             for s in seeds(getattr(args, f"{name}_seeds"))]
    got = {}
    for kind, seed, entry in runs:
        t0 = time.perf_counter()
        r = reading(args.workload, seed, args.seconds, device, entry)
        got.setdefault(kind, []).append(r)
        print(f"{kind} {args.workload} seed={seed} {json.dumps(r)} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    summary = {"workload": args.workload, "card": H.power_limit()}
    for key in KEYS:
        lower = max((r[key] for r in got.get("sound", [])), default=None)
        upper = min((r[key] for name in CONTROLS for r in got.get(name, [])),
                    default=None)
        summary[key] = {"lower": lower, "upper": upper,
                        "ratio": upper / lower if lower and upper else None}
    summary["readings"] = got
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
