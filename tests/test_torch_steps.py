"""The step builders (``repro_torch.launch.steps``) run for real on a
one-process mesh (gloo on the CPU, a ``(data=1, model=1)`` ``DeviceMesh``):

- ``build_prefill`` + ``build_decode_step`` of reduced qwen3_8b serve the
  tokens ``serve_greedy`` serves (same seed, prompt and cache length), and
  the attention kernels' wrappers see plain tensors only, never a
  ``DTensor`` (FSDP2 gathers a block's leaves before it runs);
- ``build_train_step`` at world size 1 equals ``make_local_train_step``
  bit for bit (losses, parameters, moments), qwen2_vl's unused embedding
  table included;
- a ``MeshSpec`` (no devices) raises, and the abstract arguments are
  ``meta`` tensors.
"""
import numpy as np
import pytest
import torch

from repro_torch import optim
from repro_torch.configs import Shape, get_config
from repro_torch.core.model import param_tree
from repro_torch.kernels import flash_attention as fa, flash_decode as fd
from repro_torch.launch import serve_greedy, steps, train as lt
from repro_torch.launch.mesh import MeshSpec, init_mesh, process_group
from repro_torch.models import get_model

CPU = "cpu"
B, PROMPT, GEN = 2, 16, 6


def test_prefill_and_decode_equal_serve_greedy(monkeypatch):
    cfg = get_config("qwen3_8b", reduced=True)
    want = serve_greedy(cfg, batch=B, prompt_len=PROMPT, gen_len=GEN,
                        device=CPU)
    seen = []
    for mod, name in ((fa, "flash_attention"), (fd, "flash_decode")):
        orig = getattr(mod, name)

        def spy(*a, _orig=orig, _name=name, **kw):
            seen.append((_name, [type(x) for x in a
                                 if isinstance(x, torch.Tensor)]))
            return _orig(*a, **kw)
        monkeypatch.setattr(mod, name, spy)
    shape = Shape("serve", PROMPT + GEN + 8, B, "decode")
    with process_group(CPU):
        mesh = init_mesh((1, 1), ("data", "model"), CPU)
        prefill, (meta_model, meta_batch) = steps.build_prefill(
            cfg, shape, mesh, dtype=torch.float32)
        decode, meta = steps.build_decode_step(cfg, shape, mesh,
                                               dtype=torch.float32)
        assert next(meta_model.parameters()).is_meta
        assert all(t.is_meta for t in meta_batch.values())
        assert meta[1]["k"].is_meta and meta[1]["k"].shape[2] == shape.seq_len
        model = get_model(cfg).init(cfg, seed=0, dtype=torch.float32,
                                    device=CPU)
        model = prefill.place(model)
        assert decode.place(model) is model
        logits, state = prefill(model, {"tokens": torch.as_tensor(
            want["prompt"])})
        tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        toks = [tok]
        for _ in range(GEN - 1):
            tok, state = decode(model, state, {"tokens": tok})
            toks.append(tok)
    got = torch.cat(toks, 1).numpy()
    np.testing.assert_array_equal(got, want["tokens"])
    # a prefill into a cache runs the dense path (as serve_greedy's does:
    # chip_smoke phase 10 launches no flash_attention); every decode layer
    # launches flash_decode
    assert [n for n, _ in seen] == ["flash_decode"] * (
        cfg.n_layers * (GEN - 1))
    assert all(t is torch.Tensor for _, ts in seen for t in ts)


@pytest.mark.parametrize("arch", ["gemma3_1b", "qwen2_vl_72b"])
def test_train_step_at_world_size_one_is_bit_equal_to_local(arch):
    """qwen2_vl trains on embeddings: its embedding table gets no
    gradient, and both steps update it with zeros."""
    cfg = get_config(arch, reduced=True)
    S, Bt = 32, 4
    tx = optim.adamw(3e-4, weight_decay=0.01, max_grad_norm=1.0)
    mod = get_model(cfg)
    batch_fn = lt.make_batch_fn(cfg, seq_len=S, global_batch=Bt, device=CPU)
    ref = mod.init(cfg, seed=0, dtype=torch.float32, device=CPU)
    local = lt.make_local_train_step(cfg, tx)
    ropt = tx.init(param_tree(ref))
    with process_group(CPU):
        mesh = init_mesh((1, 1), ("data", "model"), CPU)
        step, (m, o, b) = steps.build_train_step(
            cfg, Shape("t", S, Bt, "train"), mesh, dtype=torch.float32)
        assert next(m.parameters()).is_meta and b["labels"].is_meta
        assert all(t.is_meta and t.dtype == torch.float32
                   for t in o.mu.values())
        model = step.place(mod.init(cfg, seed=0, dtype=torch.float32,
                                    device=CPU))
        opt = step.init_opt(model)
        for i in range(3):
            model, opt, loss = step(model, opt, batch_fn(i))
            ref, ropt, rl = local(ref, ropt, batch_fn(i))
            assert float(loss) == float(rl)
        full = step.full_tree(model)
    for k, v in param_tree(ref).items():
        assert torch.equal(full[k], v), k
        assert torch.equal(opt.mu[k], ropt.mu[k]), k


def test_device_free_mesh_raises():
    """A ``MeshSpec`` has no devices: the builders refuse it (the dry-run
    prices it); a 'model' axis above 1 is held in
    ``test_torch_distributed.py`` on a two-rank group."""
    cfg = get_config("gemma3_1b", reduced=True)
    shape = Shape("t", 32, 4, "train")
    for build in (steps.build_train_step, steps.build_prefill,
                  steps.build_decode_step):
        with pytest.raises(TypeError, match="no devices"):
            build(cfg, shape, MeshSpec((1, 1), ("data", "model")))
