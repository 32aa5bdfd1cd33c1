"""PyTorch + CUDA port of msfno_tpu for one NVIDIA H100.

The JAX package (msfno_tpu) is the reference; this package imports nothing
of it, nor JAX.  Its entry points run on CUDA unless the caller passes
`device="cpu"`.  Kernels: msfno_torch/csrc, bound in msfno_torch/ops/kernels.
"""
