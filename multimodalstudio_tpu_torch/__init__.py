"""PyTorch/CUDA port of multimodalstudio_tpu for NVIDIA Hopper (sm_90a).

The JAX package `multimodalstudio_tpu` is the reference; this package
mirrors its module layout and is tested against it. Plain tensor code is
PyTorch; every Pallas TPU kernel on a ported path is a hand-written CUDA
kernel under `csrc/`, built with nvcc at first use (ops/kernels/build.py).

Entry points (MMSModel, Evaluator, the dataset builders) take a `device`
that defaults to "cuda" and raise when no card is present; pass
device="cpu" to run the plain PyTorch versions of the kernels instead.
"""

from multimodalstudio_tpu_torch.device import resolve_device, set_reference_precision

__all__ = ["resolve_device", "set_reference_precision"]
