"""PyTorch/CUDA port of cartpoleplusplus_tpu for one NVIDIA H100.

The JAX package ``cartpoleplusplus_tpu`` is the reference: every module here
mirrors the module of the same name there and is held against it by the
``tests/test_torch_*.py`` parity tests.  Each Pallas kernel of the reference
becomes a hand-written CUDA kernel under ``csrc/`` (built by
:mod:`cartpoleplusplus_tpu_torch.kernels`); beside each kernel sits its plain
PyTorch version, which the kernel's wrapper runs for CPU tensors.

This package imports torch and numpy only — never jax, flax or the JAX
package.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller says CPU.

    Raises when CUDA is asked for (explicitly or by default) but absent, so
    nothing falls back to the CPU quietly.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
