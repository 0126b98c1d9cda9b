"""Accelerator model: config, zoo presets and the hardware vector.

Port of ``repro.core.accel``.  The host-side :class:`AccelConfig` and the
zoo are copied as they are; the traced ``HwVec`` pytree becomes a plain
``[..., HW_FEATURE_DIM]`` f32 tensor in ``HW_FIELDS`` order, indexed with
the slot constants below (``hw[..., BPE]`` is the serving bytes/elem).

Trap kept from the reference: ``datacenter`` has ``bytes_per_elem=2``, so
a workload packed for one part and served on another is rescaled by
``hw[..., BPE] / wl["BPE"]`` inside the cost model.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

__all__ = ["AccelConfig", "PAPER_ACCEL", "ACCEL_ZOO", "HW_FIELDS",
           "HW_FEATURE_DIM", "hw_array", "stack_hw", "accel_features",
           "accel_from_features", "NPE", "LANES", "FREQ", "BW_OFF", "BW_ON",
           "BUF", "BPE", "T_PASS", "T_SYNC", "STREAM"]

MB = float(2 ** 20)


@dataclass(frozen=True)
class AccelConfig:
    npe: int = 1024
    pe_lanes: int = 4
    freq_hz: float = 1e9
    bw_offchip: float = 8e9
    bw_onchip: float = 40e9
    buf_bytes: float = 64 * MB
    bytes_per_elem: float = 1.0
    t_pass: float = 5e-6
    t_sync: float = 20e-6
    stream_buf_bytes: float = 2 * MB
    name: str = "edge"               # zoo identity (not part of the hw vector)

    @property
    def peak_macs(self) -> float:
        return self.npe * self.pe_lanes * self.freq_hz

    def with_buffer_mb(self, mb: float) -> "AccelConfig":
        return replace(self, buf_bytes=mb * MB)


PAPER_ACCEL = AccelConfig()

ACCEL_ZOO: dict[str, AccelConfig] = {
    "edge": PAPER_ACCEL,
    "nano": AccelConfig(
        name="nano", npe=256, pe_lanes=2, freq_hz=8e8, bw_offchip=4e9,
        bw_onchip=16e9, buf_bytes=8 * MB, bytes_per_elem=1.0, t_pass=5e-6,
        t_sync=30e-6, stream_buf_bytes=1 * MB),
    "mobile": AccelConfig(
        name="mobile", npe=2048, pe_lanes=4, freq_hz=1e9, bw_offchip=25.6e9,
        bw_onchip=128e9, buf_bytes=32 * MB, bytes_per_elem=1.0, t_pass=4e-6,
        t_sync=15e-6, stream_buf_bytes=2 * MB),
    "laptop": AccelConfig(
        name="laptop", npe=4096, pe_lanes=4, freq_hz=1.2e9, bw_offchip=68e9,
        bw_onchip=400e9, buf_bytes=96 * MB, bytes_per_elem=1.0, t_pass=3e-6,
        t_sync=12e-6, stream_buf_bytes=4 * MB),
    "datacenter": AccelConfig(
        name="datacenter", npe=16384, pe_lanes=8, freq_hz=1.5e9,
        bw_offchip=300e9, bw_onchip=2400e9, buf_bytes=192 * MB,
        bytes_per_elem=2.0, t_pass=2e-6, t_sync=10e-6,
        stream_buf_bytes=8 * MB),
}

HW_FIELDS = ("npe", "pe_lanes", "freq_hz", "bw_offchip", "bw_onchip",
             "buf_bytes", "bytes_per_elem", "t_pass", "t_sync",
             "stream_buf_bytes")
HW_FEATURE_DIM = len(HW_FIELDS)
(NPE, LANES, FREQ, BW_OFF, BW_ON, BUF, BPE, T_PASS, T_SYNC,
 STREAM) = range(HW_FEATURE_DIM)

_FEAT_LO = np.array([32, 1, 1e8, 1e8, 1e9, 0.25 * MB, 0.25, 1e-7, 1e-7,
                     0.0625 * MB], np.float64)  # repro_torch: noqa[TDET002] -- host feature-normalization bounds, never on the device
_FEAT_HI = np.array([2 ** 20, 64, 1e10, 1e13, 1e14, 16384 * MB, 8.0, 1e-3,
                     1e-2, 1024 * MB], np.float64)  # repro_torch: noqa[TDET002] -- host feature-normalization bounds, never on the device


def hw_array(hw, device=None) -> torch.Tensor:
    """Raw ``[..., HW_FEATURE_DIM]`` f32 vector of an ``AccelConfig`` (or
    an array-like already in ``HW_FIELDS`` order)."""
    if isinstance(hw, AccelConfig):
        vals = np.array([float(getattr(hw, f)) for f in HW_FIELDS],
                        np.float32)
        return torch.as_tensor(vals, device=device)
    return torch.as_tensor(hw, dtype=torch.float32, device=device)


def stack_hw(hw, C: int, device=None) -> torch.Tensor:
    """Per-condition hardware rows ``[C, HW_FEATURE_DIM]``.

    ``hw`` may be one descriptor (broadcast), a sequence of C
    descriptors, or a ``[C, HW_FEATURE_DIM]`` array/tensor."""
    if isinstance(hw, (list, tuple)):
        if len(hw) != C:
            raise ValueError(f"got {len(hw)} accelerators for {C} conditions")
        return torch.stack([hw_array(h, device) for h in hw]).contiguous()
    v = hw_array(hw, device)
    if v.dim() == 1:
        return v.expand(C, HW_FEATURE_DIM).contiguous()
    if v.shape != (C, HW_FEATURE_DIM):
        raise ValueError(f"stacked hw has shape {tuple(v.shape)}, expected "
                         f"({C}, {HW_FEATURE_DIM})")
    return v.contiguous()


def accel_features(hw, device=None) -> torch.Tensor:
    """Normalized hardware condition features in [0, 1], log-linear over
    each field's design range; invertible via :func:`accel_from_features`."""
    x = hw_array(hw, device)
    lo = torch.as_tensor(_FEAT_LO.astype(np.float32), device=x.device)
    span = torch.as_tensor(np.log(_FEAT_HI / _FEAT_LO).astype(np.float32),
                           device=x.device)
    return torch.log(x / lo) / span


def accel_from_features(feats, name: str = "decoded") -> AccelConfig:
    """Invert :func:`accel_features` back to an :class:`AccelConfig`."""
    if isinstance(feats, torch.Tensor):
        feats = feats.detach().cpu().numpy()
    f = np.asarray(feats, np.float64)  # repro_torch: noqa[TDET002] -- host feature decode after the copy; round-trips at f32 precision
    if f.shape != (HW_FEATURE_DIM,):
        raise ValueError(f"expected [{HW_FEATURE_DIM}] features, "
                         f"got shape {f.shape}")
    raw = _FEAT_LO * np.exp(f * np.log(_FEAT_HI / _FEAT_LO))
    kw = dict(zip(HW_FIELDS, raw))
    kw["npe"] = int(round(kw["npe"]))
    kw["pe_lanes"] = int(round(kw["pe_lanes"]))
    return AccelConfig(name=name, **kw)
