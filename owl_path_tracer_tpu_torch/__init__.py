"""owl_path_tracer_tpu_torch -- the wavefront path tracer in PyTorch + CUDA.

A port of ``owl_path_tracer_tpu`` (JAX/Pallas) to PyTorch with hand-written
Hopper kernels.  The JAX package stays the reference: every module here has a
counterpart at the same path there, with the same function names, and the
tests hold the two against each other.

Conventions:
  * plain functions on tensors; scene, materials and accelerators are
    dataclasses of tensors with ``.to(device)``;
  * every function that creates tensors takes an explicit ``device``; there
    is no global device choice -- work runs on CPU only when the caller
    hands it CPU tensors;
  * a kernel wrapper launches its CUDA kernel for CUDA tensors (or raises)
    and uses its plain PyTorch version for CPU tensors;
  * float32 matmuls and convolutions never run in TF32 (set below).
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
