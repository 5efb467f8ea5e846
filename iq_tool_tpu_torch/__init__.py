"""iq_tool_tpu_torch: the I/Q stream-processing chain on PyTorch + CUDA.

A port of ``iq_tool_tpu`` (JAX/Pallas on a TPU) for NVIDIA Hopper.  It
imports torch and nothing of ``iq_tool_tpu``: it keeps its own copies of
the reference's host code (formats, constants, presets, the input/output
modules, io, utils), and ports everything else.  The Pallas kernels on
the chain's path are hand-written CUDA kernels (``csrc/``), built with
nvcc at first use; each has a plain PyTorch twin that runs on CPU
tensors.
"""

__version__ = "0.1.0"

from iq_tool_tpu_torch.formats import FORMATS, SampleFormat, get_format  # noqa: E402,F401
