"""Run one cell of the benchmark once, from the root of a checkout:

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Sets up the cell (imports, the port's kernel build on a cold cache,
weights, packing, a warm-up of the cell's own shapes), then either
measures its end-to-end metrics over ``--seconds`` (``--trace 0``) or
profiles a short window and reads its per-layer metrics (``--trace 1``);
then frees the program's state, compares what the window produced with
the plain reference, prints each number compared beside its limit as the
last lines of standard error, and prints one JSON line as the last line
of standard output.  Exits non-zero without a result when no CUDA card is
present, when fewer cards are present than the cell asks for, when the
port's package is not beside it, or when JAX or the JAX package has been
loaded.  Caches (Triton, PyTorch extensions) go to fixed directories
under ``build/`` in the checkout; the port builds its kernels there too.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "perfbench" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "perfbench"
                                         / "torch_extensions")
os.environ["USE_FLAX"] = "0"


def fail(code: int, msg: str) -> None:
    print(f"perfbench: {msg}", file=sys.stderr)
    sys.exit(code)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        fail(2, "--seed must be a whole number >= 0")
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        fail(2, f"the port's package is not beside the benchmark "
                f"({ROOT / 'src' / 'repro_torch'} is missing)")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench.harness import cell as harness
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    chips = int(harness.find(bench["workloads"], args.workload,
                             "workload")["chips"])
    import torch
    if not torch.cuda.is_available():
        fail(3, "no CUDA device")
    if torch.cuda.device_count() < chips:
        fail(3, f"the cell asks for {chips} cards, "
                f"{torch.cuda.device_count()} present")
    out = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", T_START)
    bad = harness.loaded_forbidden()
    if bad:
        fail(4, f"JAX or the JAX package was loaded: {', '.join(bad)}")
    checks = out.pop("checks")
    for k, (v, lim) in checks.items():
        print(f"check {k} = {v!r} (limit {lim!r})", file=sys.stderr)
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
