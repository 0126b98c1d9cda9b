"""Batched LM serving on the PyTorch port: prefill + greedy decode.

    PYTHONPATH=src python examples/serve_llm_torch.py [--arch qwen3_8b]
        [--device cpu]

The twin of ``examples/serve_llm.py`` on ``repro_torch``: it serves the
reduced config of any of the ten archs (dense, MoE, VLM backbone, RWKV6,
Hymba, Whisper) on the CUDA card, or on the CPU with ``--device cpu``.
"""
import argparse

from repro_torch.configs import ARCH_NAMES
from repro_torch.launch import serve_greedy


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3_8b", choices=ARCH_NAMES)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch path (default: cuda)")
    args = ap.parse_args(argv)
    out = serve_greedy(args.arch, batch=4, prompt_len=32, gen_len=16,
                       device=args.device)
    print(f"arch={args.arch}: prefill {out['t_prefill_s']*1e3:.0f} ms, "
          f"decode {out['tok_per_s']:.1f} tok/s")
    print("sampled tokens[0]:", out["tokens"][0].tolist())


if __name__ == "__main__":
    main()
