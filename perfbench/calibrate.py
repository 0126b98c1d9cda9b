"""The readings that the limits of ``correct`` are set from, for one cell,
in one process on the card:

    python3 perfbench/calibrate.py --workload <name> --seconds <s> \\
        --seeds 1,2,...  --control-seeds 101,102,103

For each of ``--seeds`` one run of the cell as ``run.py --trace 0`` runs
it (a window of ``--seconds``, then the comparison), with ``--fault``'s
fault planted where one is named (``harness/faults.py``), and for each of
``--control-seeds`` the same run with the control, the reference in the
next lower precision than the configuration's (the driver's ``CONTROL``),
in the program's place.  Prints one JSON line a run: the seed, whether it
was the control, every number compared with its limit, and the run's
end-to-end metrics.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", default="",
                    help="plant this fault of harness/faults.py in the "
                         "runs of --seeds")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    import contextlib
    from perfbench.harness import cell as harness, faults
    if not torch.cuda.is_available():
        sys.exit("calibrate: no CUDA device")
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    c = harness.resolve(bench, args.workload)
    runs = [(int(s), None) for s in args.seeds.split(",") if s]
    runs += [(int(s), c.driver.CONTROL) for s in args.control_seeds.split(",")
             if s]
    for seed, control in runs:
        t0 = time.perf_counter()
        plant = (faults.FAULTS[args.fault]() if args.fault and control is None
                 else contextlib.nullcontext())
        with plant:
            out = harness.run_resolved(c, seed, args.seconds, False, "cuda",
                                       t0, control)
        print(json.dumps({
            "seed": seed, "control": control is not None,
            "fault": args.fault if control is None else "",
            "correct": out["correct"],
            "checks": {k: v for k, (v, _) in out["checks"].items()},
            "limits": {k: lim for k, (_, lim) in out["checks"].items()},
            "metrics": {k: m["value"] for k, m in out["metrics"].items()},
            "run_s": time.perf_counter() - t0}), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
