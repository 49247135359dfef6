"""randomfield_tpu_torch — the Gaussian random field generator on PyTorch + CUDA.

A port of ``randomfield_tpu`` (JAX on a TPU) to PyTorch with hand-written
CUDA kernels for the NVIDIA H100.  It imports torch and never jax; the JAX
package beside it is the reference its tests hold it to, at the same
Threefry seed.

    import randomfield_tpu_torch as rft
    g = rft.Generator(256, 256, 256, grid_spacing=4.0)   # device="cuda"
    delta = g.generate_delta_field(seed=0)               # (256, 256, 256)

The CUDA kernels (``csrc/``) are built with nvcc at first use; on CPU
tensors every kernel runs its plain PyTorch version (``device="cpu"``).
"""

from randomfield_tpu_torch.engine.generator import Generator
from randomfield_tpu_torch.ops.power import load_default_power, validate_power

__all__ = ["Generator", "load_default_power", "validate_power"]
