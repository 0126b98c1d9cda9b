"""A/B of builds of ``flash_attention.cu`` on one CUDA card, in one process.

    PYTHONPATH=src python -m repro_torch.ab_flash_attention [SOURCE ...]

Builds this tree's ``kernels/csrc/flash_attention.cu`` and each SOURCE (a
``flash_attention.cu``, or a checkout whose one is read) with the same
``nvcc`` flags, into ``build/ab_flash_attention/``, then times the f32
path of each build in turns (every build, then every build again in the
reverse order) at qwen3_8b's self-check shape [4, 1151, Hq 32 / Hkv 8, hd
128, causal] and its scoring shape [2, 4096], beside the 3xTF32 bound.
Each build is also checked against the plain twin (its worst error over
the f32 gate, 2e-5 + 2e-5 |plain|) and, at q and k scaled by 4 and 8,
against an f64 attention (its error over the twin's).  A SOURCE whose f32
launch is ``flash_attention_cc_launch`` (the CUDA-core kernel that the
3xTF32 one replaced) is timed through that.  ``chip_smoke.py
--parent-fa`` builds its parent's kernel with :func:`start_build`.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import math
import pathlib
import subprocess

import numpy as np
import torch

from .kernels import _build, flash_attention as fa

OUT = _build.BUILD_DIR.parent / "ab_flash_attention"
SHAPES = ((4, 1151), (2, 4096))         # (B, S) at Hq 32 / Hkv 8, hd 128
H100_TF32_OPS_PER_S = 495e12            # TF32 on the tensor cores, dense


class _Lib:
    """A stand-in for the built library in ``fa._lib()``, whose launches
    are another build's."""
    _argtypes_set = True


def start_build(src: pathlib.Path, name: str):
    """Start ``nvcc`` on ``src`` (a ``flash_attention.cu`` or a checkout)
    with this tree's flags; returns (process, library path)."""
    if src.is_dir():
        src = src / "src" / "repro_torch" / "kernels" / "csrc" / \
            "flash_attention.cu"
    if not src.is_file():
        raise FileNotFoundError(src)
    out = OUT / name / "libflash_attention.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen(
        [_build._nvcc(), *_build.flags("flash_attention"), "-o", str(out),
         str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    return proc, out


def finish_build(job) -> _Lib:
    """The build's library, its f32 launch (``flash_attention_cc_launch``
    where it has one, else ``flash_attention_tf32_launch``) and its bf16
    one standing in for this tree's."""
    proc, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {out.parent.name}:\n{log}")
    lib = ctypes.CDLL(str(out))
    f32 = getattr(lib, "flash_attention_cc_launch", None) or \
        lib.flash_attention_tf32_launch
    shim = _Lib()
    shim.log = log
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # builds whose launches take one head dim lack flash_attention_tc_pairs
    pairs = hasattr(lib, "flash_attention_tc_pairs")
    for name, fn in (("flash_attention_tf32_launch", f32),
                     ("flash_attention_tc_launch",
                      lib.flash_attention_tc_launch)):
        fn.argtypes = [vp] * 4 + [ci] * (7 if pairs else 6) + [ll] * 9 \
            + [ci] * 2 + [vp]
        fn.restype = ci
        setattr(shim, name, fn if pairs else _one_head_dim(fn))
    return shim


def _one_head_dim(fn):
    """A launch that takes one head dim, called as this tree's, which
    take the (q/k, v) pair: an unequal pair is refused as the launch
    refuses a head dim it lacks (cudaErrorInvalidValue)."""
    def launch(*a):
        return fn(*a[:10], *a[11:]) if a[9] == a[10] else 1
    return launch


@contextlib.contextmanager
def swap(lib):
    """``flash_attention`` launches ``lib``'s kernels inside the block
    (this tree's where ``lib`` is None)."""
    keep = _build._LIBS.get(fa.SOURCE)
    if lib is not None:
        _build._LIBS[fa.SOURCE] = lib
    try:
        yield
    finally:
        if keep is None:
            _build._LIBS.pop(fa.SOURCE, None)
        else:
            _build._LIBS[fa.SOURCE] = keep


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds a call over ``reps`` calls, by CUDA events, after
    one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def tf32x3_bound_ms(B: int, S: int, Hq: int, hd: int) -> float:
    """Causal f32 attention's 3xTF32 operations over the TF32 peak."""
    pairs = S * (S + 1) // 2
    return 3 * 4 * hd * pairs * B * Hq / H100_TF32_OPS_PER_S * 1e3


def attention_f64(q, k, v, causal: bool):
    """Masked dense softmax attention in f64 on q's device."""
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    qg = q.double().reshape(B, S, Hkv, Hq // Hkv, hd)
    s = torch.einsum("bskgh,btkh->bkgst", qg, k.double()) / math.sqrt(hd)
    if causal:
        ok = torch.ones(S, T, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~ok, float("-inf"))
    out = torch.einsum("bkgst,btkh->bskgh", torch.softmax(s, -1), v.double())
    return out.reshape(B, S, Hq * hd)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sources", nargs="*", type=pathlib.Path,
                    help="flash_attention.cu files or checkouts to time "
                    "beside this tree's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_flash_attention: no CUDA device")
    names = [f"{i}_{p.stem if p.is_file() else p.name}"
             for i, p in enumerate(args.sources)]
    jobs = [start_build(p, n) for p, n in zip(args.sources, names)]
    _build.build(fa.SOURCE)
    libs = {"this": None}
    for n, job in zip(names, jobs):
        libs[n] = finish_build(job)
    for n, lib in libs.items():
        log = _build.build_info(fa.SOURCE)["log"] if lib is None else lib.log
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "injected" in line:
                print(f"  ptxas {n}: {line.strip()}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    mk = lambda *sh: torch.as_tensor(rng.normal(size=sh),
                                     dtype=torch.float32, device=dev)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for B, S in SHAPES:
        q, k, v = mk(B, S, 32, 128), mk(B, S, 8, 128), mk(B, S, 8, 128)
        want = fa.flash_attention_plain(q, k, v)
        run = lambda: fa.flash_attention(q, k, v)
        ms = {n: [] for n in libs}
        gate = {}
        for n in list(libs) + list(libs)[::-1]:
            with swap(libs[n]):
                ms[n].append(time_ms(run, 10))
                got = run()
            gate[n] = float(((got - want).abs()
                             / (2e-5 + 2e-5 * want.abs())).max())
        print(f"[{B},{S}] 3xTF32 bound {tf32x3_bound_ms(B, S, 32, 128):.4f} "
              f"ms: " + "; ".join(
                  f"{n} " + "/".join(f"{x:.4f}" for x in ms[n])
                  + f" ms (gate x{gate[n]:.3g})" for n in libs))
        del q, k, v, want
    for B, S, Hq, Hkv, hd, causal in ((1, 1024, 8, 2, 128, True),
                                      (4, 1151, 32, 8, 128, True),
                                      (1, 300, 4, 4, 64, False)):
        for scale in (4.0, 8.0):
            q, k = mk(B, S, Hq, hd) * scale, mk(B, S, Hkv, hd) * scale
            v = mk(B, S, Hkv, hd)
            exact = attention_f64(q, k, v, causal)
            twin = float((fa.flash_attention_plain(q, k, v, causal=causal)
                          .double() - exact).abs().max())
            row = []
            for n, lib in libs.items():
                with swap(lib):
                    got = fa.flash_attention(q, k, v, causal=causal)
                err = float((got.double() - exact).abs().max())
                row.append(f"{n} {err / twin:.3f}")
            print(f"  x{scale:g} [{B},{S},{Hq}/{Hkv},{hd}] error against f64 "
                  f"over the twin's ({twin:.3g}): " + ", ".join(row))
            del q, k, v, exact
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
