"""Hand-written CUDA kernels of the port, each with its plain PyTorch twin.

One module per kernel, each holding its wrapper, its plain twin and its
launch count:

- ``fusion_eval`` (``csrc/fusion_eval.cu``) replaces the reference's
  Pallas ``_fe_kernel`` and the CostOut reduction after it;
- ``flash_attention`` (``csrc/flash_attention.cu``) its ``_fa_kernel``;
- ``flash_decode`` (``csrc/flash_decode.cu``) its ``_fd_kernel`` and the
  merge after it;
- ``rwkv6_scan`` (``csrc/wkv6.cu``) its ``_wkv_kernel``.

``dense_attention`` is the masked softmax math that the attention twins
and ``nn.attention``'s dense route share.  Sources are built with ``nvcc``
at first use (``_build``).  Importing this package imports none of its
modules and builds nothing, so ``nn`` can import the attention and WKV
kernels while ``fusion_eval`` imports ``core``."""

__all__ = ["fusion_eval", "flash_attention", "flash_decode", "rwkv6_scan",
           "dense_attention"]
