"""PyTorch/CUDA port of the DNNFuser reproduction, for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package computes the same
functions in PyTorch and never imports ``jax`` or ``repro``.

Port contract
-------------
Layout.  The subpackages mirror ``repro``'s: ``workloads/`` (numpy-only
copies of the layer IR and the CNN zoo), ``core/`` (``accel``,
``cost_model``, ``env``, ``model``, ``backend``, ``infer``, ``gsampler``,
and the paper loop's ``dataset`` -- the teacher corpus -- and ``train``),
``core/polish`` and ``core/portfolio`` (the refiners the serving engine
escalates to), ``serving/`` (the engine, its async scheduler, the
strategy cache, drift detection and the refresh-and-swap loop),
``optim/`` (the hand-written AdamW and SGD and the learning-rate
schedules), ``configs/`` (copies of the ten LM arch configs), ``nn/`` (dense,
LayerNorm, RMSNorm, RoPE, GQA attention with windows, qk-norm, a KV cache
and the ``impl`` dispatch to the kernels, the pre-norm block),
``models/`` (the dense LM and the registry), ``launch/`` (greedy
serving), ``kernels/`` (hand-written CUDA kernels under ``kernels/csrc/``
with their Python wrappers) and ``checkpoint/`` (a writer, a reader and
a ``Checkpointer`` of the reference checkpoint format, byte-compatible
with the reference's, through which weights cross packages).

Device policy.  Entry points that create tensors (``pack_workload``,
``FusionEnv``, ``dt_init``, ``gsampler_search_grid``,
``generate_teacher_corpus``, ``collect_teacher_data``,
``dnnfuser_infer_batch``, ``polish_grid``, ``de_search_grid``, ...), the
training loop (``train_model``, ``fine_tune``) and the serving stack
(``MapperEngine``, :func:`serve`) run on ``cuda`` unless the caller passes
``device="cpu"``; with no card and no
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
seeded from a config, or a numpy ``default_rng`` where the reference
draws from numpy (the host G-Sampler, jitter augmentation, training
batches), whose streams are then the reference's.  Torch streams are not
JAX's threefry streams, so the grid GA and init are deterministic per
seed within the port and compared with the reference on quality, not
bytes.  Training is bit-exact per seed on the card and on resume.
"""
from __future__ import annotations

import torch

# name -> home submodule of every public symbol, resolved lazily on first
# access (``import repro_torch`` stays cheap): the port's subset of the
# reference's public table (no seq2seq baseline, no replicas).
_PUBLIC = {
    # the paper core: model + one-shot inference
    "DTConfig": "core", "dt_init": "core", "dt_loss": "core",
    "dnnfuser_infer": "core", "dnnfuser_infer_batch": "core",
    "InferResult": "core",
    # teacher + training
    "GSamplerConfig": "core", "gsampler_search": "core",
    "generate_teacher_corpus": "core", "TrajectoryDataset": "core",
    "TrainConfig": "core", "train_model": "core", "fine_tune": "core",
    "restore_params": "core",
    # the hardware-condition space
    "AccelConfig": "core", "ACCEL_ZOO": "core", "PAPER_ACCEL": "core",
    "HW_FEATURE_DIM": "core", "accel_features": "core",
    # the serving stack
    "ServingConfig": "serving", "DriftConfig": "serving",
    "MapperEngine": "serving", "MapRequest": "serving",
    "MapResponse": "serving", "StrategyCache": "serving",
    "AsyncMapperScheduler": "serving", "MapFuture": "serving",
    "AdmissionError": "serving", "DriftMonitor": "serving",
    "DriftReport": "serving", "RefreshWorker": "serving",
    # workloads
    "Workload": "workloads", "CNN_ZOO": "workloads",
    "get_workload": "workloads", "vgg16": "workloads",
    "resnet18": "workloads", "resnet50": "workloads",
    "mobilenet_v2": "workloads", "mnasnet_b1": "workloads",
    "tiny_cnn": "workloads",
}

__all__ = ["DEFAULT_DEVICE", "resolve_device", "serve"] + sorted(_PUBLIC)


def __getattr__(name):
    if name in _PUBLIC:
        import importlib
        mod = importlib.import_module(f".{_PUBLIC[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))

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


def serve(model, config=None, *, warm=None, accel=None, device=None):
    """Build the serving stack -- engine + async scheduler -- from one frozen
    ``ServingConfig`` (default ``ServingConfig()``).

    ``model`` is the port's DT, on ``device`` (``cuda`` unless ``"cpu"``).
    With ``warm`` (a list of workloads, optionally ``accel``) the engine is
    warmed up first, so steady-state traffic over those shapes adds no
    signature and the drift monitor knows the in-distribution conditions.
    Returns the ``AsyncMapperScheduler``; its ``.engine`` is the
    ``MapperEngine``."""
    from . import serving
    engine = serving.MapperEngine.from_config(model, config, device=device)
    if warm:
        engine.warmup(list(warm), accel)
    return serving.AsyncMapperScheduler(engine, config=engine.serving_config)
