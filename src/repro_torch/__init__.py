"""PyTorch/CUDA port of the P-EAGLE serving stack for one NVIDIA H100.

Module names mirror the JAX package (``repro``) so each counterpart is easy
to find; the port imports torch and numpy only. Public functions keep the
JAX layouts: weights ``(d_in, d_out)`` applied as ``x @ W``, activations
``(B, S, D)``, heads ``(B, S, H, hd)``, KV caches ``k/v (B, max_len, KV,
hd)`` with ``positions (B, max_len)`` int32 (-1 = empty). The attention
kernels are hand-written CUDA C++ for sm_90a (``repro_torch.kernels``).
"""
