"""6-loop layer IR for the fusion map-space.

The paper (Eq. 2) describes every layer with the 6-loop CONV notation
``[K, C, Y, X, R, S]`` (output channels, input channels, output height,
output width, kernel height, kernel width).  Matmuls / FC layers / attention
blocks are expressed in the same notation via factory helpers, so the mapper
state features stay uniform across CNN and LM workloads.

A :class:`Workload` is a *chain* of layers (the paper's strategy vector is a
chain decision); residual/skip edges are annotated per-layer via
``skip_src`` and handled by the cost model as held-buffer / crossing-traffic
terms.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["Layer", "Workload"]


@dataclass(frozen=True)
class Layer:
    """One fusible layer in 6-loop notation.

    ``macs``/``out_elems``/``w_elems`` are *per input sample* and default to
    the conv formulas; the factories override them for non-conv ops.
    ``skip_src`` is the 1-based position (in the chain, 0 = network input) of
    a residual source whose activation must be live until this layer
    consumes it; ``-1`` means no skip edge.
    """

    name: str
    K: int
    C: int
    Y: int
    X: int
    R: int = 1
    S: int = 1
    stride: int = 1
    groups: int = 1
    skip_src: int = -1
    # Explicit overrides (per-sample); ``None`` -> derived from the 6 loops.
    macs_override: float | None = None
    out_elems_override: float | None = None
    w_elems_override: float | None = None

    # ---- derived quantities (per sample) ---------------------------------
    @property
    def macs(self) -> float:
        if self.macs_override is not None:
            return float(self.macs_override)
        return float(self.K) * self.C * self.Y * self.X * self.R * self.S / self.groups

    @property
    def out_elems(self) -> float:
        if self.out_elems_override is not None:
            return float(self.out_elems_override)
        return float(self.K) * self.Y * self.X

    @property
    def w_elems(self) -> float:
        if self.w_elems_override is not None:
            return float(self.w_elems_override)
        return float(self.K) * self.C * self.R * self.S / self.groups

    @property
    def util_cap(self) -> float:
        """Max PE-array utilization. Depthwise convs lack channel-reduction
        parallelism and run rigid spatial arrays at ~8% (MAESTRO-consistent)."""
        if self.groups > 1 and self.groups == self.C:
            return 0.08
        return 1.0

    @property
    def shape6(self) -> tuple[int, int, int, int, int, int]:
        return (self.K, self.C, self.Y, self.X, self.R, self.S)

    # ---- factories --------------------------------------------------------
    @staticmethod
    def conv(name: str, k: int, c: int, y: int, x: int, r: int, s: int,
             stride: int = 1, groups: int = 1, skip_src: int = -1) -> "Layer":
        return Layer(name, k, c, y, x, r, s, stride, groups, skip_src)

    @staticmethod
    def depthwise(name: str, c: int, y: int, x: int, r: int, s: int,
                  stride: int = 1, skip_src: int = -1) -> "Layer":
        return Layer(name, c, c, y, x, r, s, stride, groups=c, skip_src=skip_src)

    @staticmethod
    def matmul(name: str, m: int, k: int, n: int, skip_src: int = -1,
               w_elems: float | None = None, macs: float | None = None) -> "Layer":
        """A per-sample matmul ``[m, k] @ [k, n]`` as a 1x1 'conv'.

        6-loop view: K=n (out features), C=k (in features), Y=m (rows /
        tokens), X=1, R=S=1 -> macs = m*k*n, out = m*n, w = k*n.
        """
        return Layer(name, K=n, C=k, Y=m, X=1, R=1, S=1, skip_src=skip_src,
                     macs_override=macs, w_elems_override=w_elems)

    @staticmethod
    def op(name: str, macs: float, out_elems: float, w_elems: float,
           shape6: tuple[int, int, int, int, int, int], skip_src: int = -1) -> "Layer":
        """Fully explicit op (e.g. a whole transformer block)."""
        K, C, Y, X, R, S = shape6
        return Layer(name, K, C, Y, X, R, S, skip_src=skip_src,
                     macs_override=macs, out_elems_override=out_elems,
                     w_elems_override=w_elems)


@dataclass
class Workload:
    """A chain of layers plus the network-input pseudo tensor.

    Position 0 is the network input (``input_elems`` per sample, with a
    pseudo 6-loop shape for the mapper state); positions ``1..N`` are layers.
    """

    name: str
    layers: list[Layer]
    input_elems: float
    input_shape6: tuple[int, int, int, int, int, int]
    default_batch: int = 64

    @property
    def n(self) -> int:
        return len(self.layers)

    def act_elems(self) -> np.ndarray:
        """Per-sample activation elems at positions 0..N (0 = input)."""
        return np.array([self.input_elems] + [l.out_elems for l in self.layers],
                        dtype=np.float64)

    def arrays(self, nmax: int, bytes_per_elem: float = 4.0) -> dict[str, np.ndarray]:
        """Pad to ``nmax`` positions (incl. input) for the cost model.

        Returns float64/int32 numpy arrays; the cost model casts to f32.
        Keys: A (act bytes/sample), W (weight bytes), F (macs/sample),
        OE (out elems), SKIP (skip src position or -1), SHAPE6 (state feats),
        mask (valid layer positions, position 0 excluded), n (num layers).
        """
        n = self.n
        if n + 1 > nmax:
            raise ValueError(f"{self.name}: n+1={n + 1} > nmax={nmax}")
        A = np.zeros(nmax); W = np.zeros(nmax); F = np.zeros(nmax)
        OE = np.ones(nmax); UC = np.ones(nmax)
        SKIP = np.full(nmax, -1, dtype=np.int32)
        SHAPE6 = np.ones((nmax, 6))
        mask = np.zeros(nmax, dtype=bool)
        A[: n + 1] = self.act_elems() * bytes_per_elem
        SHAPE6[0] = np.array(self.input_shape6, dtype=np.float64)
        for i, l in enumerate(self.layers, start=1):
            W[i] = l.w_elems * bytes_per_elem
            F[i] = l.macs
            OE[i] = max(l.out_elems, 1.0)
            UC[i] = l.util_cap
            SKIP[i] = l.skip_src
            SHAPE6[i] = np.array(l.shape6, dtype=np.float64)
            mask[i] = True
        return dict(A=A, W=W, F=F, OE=OE, UC=UC, SKIP=SKIP, SHAPE6=SHAPE6,
                    mask=mask, n=np.int32(n))

    def total_macs(self, batch: int | None = None) -> float:
        b = batch if batch is not None else self.default_batch
        return b * sum(l.macs for l in self.layers)

    def total_weight_bytes(self, bytes_per_elem: float = 4.0) -> float:
        return bytes_per_elem * sum(l.w_elems for l in self.layers)

    def summary(self) -> str:
        rows = [f"{self.name}: {self.n} layers, "
                f"{sum(l.macs for l in self.layers) / 1e9:.2f} GMACs/sample, "
                f"{self.total_weight_bytes() / 1e6:.1f} MB weights (fp32)"]
        return "\n".join(rows)
