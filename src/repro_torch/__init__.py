"""PyTorch/CUDA port of the DNNFuser reproduction, for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package computes the same
functions in PyTorch and never imports ``jax`` or ``repro``.

Port contract
-------------
Layout.  The subpackages mirror ``repro``'s: ``workloads/`` (numpy-only
copies of the layer IR and the CNN zoo), ``core/`` (``accel``,
``cost_model``, ``env``, ``model``, ``backend``, ``infer``, ``gsampler``),
``configs/`` (copies of the ten LM arch configs), ``nn/`` (dense,
LayerNorm, RMSNorm, RoPE, GQA attention with windows, qk-norm, a KV cache
and the ``impl`` dispatch to the kernels, the pre-norm block),
``models/`` (the dense LM and the registry), ``launch/`` (greedy
serving), ``kernels/`` (hand-written CUDA kernels under ``kernels/csrc/``
with their Python wrappers) and ``checkpoint/`` (a numpy-only reader of
the reference checkpoint format, through which weights cross packages).

Device policy.  Entry points that create tensors (``pack_workload``,
``dt_init``, ``gsampler_search_grid``, ``dnnfuser_infer_batch``, ...) run
on ``cuda`` unless the caller passes ``device="cpu"``; with no card and no
``device="cpu"`` they raise (:func:`resolve_device`) instead of carrying on
quietly on the CPU.  Functions that take tensors run where the tensors
are.  TF32 is off for matmuls and cuDNN: parity needs full f32.

Kernels.  Each kernel has a plain PyTorch twin in its module.  A wrapper
runs the twin only because the tensor it was given lies on the CPU; on a
CUDA tensor it launches the kernel or raises -- there is no fallback.
Each wrapper counts its launches, so a run can show that the main path
went through the kernel.

Oracles and tolerances.  The port is held, on the same numpy-made inputs,
against the reference's XLA paths (``evaluator="xla"``, ``impl="xla"``),
against ``repro.kernels.ref`` and against the f64 loop model
``repro.core.ref_model`` -- never against a Pallas interpret path.
Integer outputs (strategies, decoded actions, ``gid``, ``valid``,
``n_groups``, greedy tokens) are equal; cost-model floats agree within
rtol 1e-5; DT logits within atol 1e-5; LM logits within 2e-4 (the
reference's own model tolerance); attention within 2e-5 (f32) or 2e-2
(bf16), the reference's kernel-sweep tolerances.  On the card the
``fusion_eval`` kernel and its plain twin agree bit for bit (both round
each operation in the same order; the kernel is built with
``-fmad=false``); the attention kernels sum in another order than their
twins and are held to the sweep tolerances.

Randomness.  Every random draw takes an explicit ``torch.Generator``
seeded from a config; torch streams are not JAX's threefry streams, so
stochastic parts (GA, init) are deterministic per seed within the port
and compared with the reference on quality, not bytes.
"""
from __future__ import annotations

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device"]

DEFAULT_DEVICE = "cuda"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless ``device`` says
    otherwise.  Raises when a CUDA device is asked for (explicitly or by
    default) and none is present."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
