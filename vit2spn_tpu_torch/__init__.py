"""PyTorch/CUDA port of vit2spn_tpu.

A second package beside the JAX one, with the same module layout and names.
It imports torch and numpy only — never jax and never the JAX package — and
its hot path runs through hand-written CUDA kernels for Hopper
(`vit2spn_tpu_torch/csrc/`). Entry points run on `cuda` unless the caller
passes `device="cpu"`; on the CPU every kernel wrapper uses its plain PyTorch
twin.
"""
