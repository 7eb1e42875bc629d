"""SAM-PT in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

A port of `sam_pt_tpu` (JAX), which stays the reference: every module here
is tested against its JAX counterpart on the same inputs and weights. This
package imports `torch` and never `jax`.
"""
