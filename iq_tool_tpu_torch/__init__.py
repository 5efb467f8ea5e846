"""iq_tool_tpu_torch: the I/Q stream-processing chain on PyTorch + CUDA.

A port of ``iq_tool_tpu`` (JAX/Pallas on a TPU) for NVIDIA Hopper.  It
imports torch and never jax: the jax-free host code of the reference
package (formats, constants, presets, input/output modules, io, utils)
is shared, everything else is ported here.  The Pallas kernels on the
chain's path are hand-written CUDA kernels (``csrc/``), built with nvcc
at first use; each has a plain PyTorch twin that runs on CPU tensors.
"""

__version__ = "0.1.0"
