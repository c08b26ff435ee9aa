"""PyTorch/CUDA port of the Apodotiko FL simulator (reference: ``repro``).

The package imports ``torch`` and never ``jax``, and nothing of the JAX
package ``repro``: the jax-free reference modules it needs are kept here as
copies. Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (``repro_torch.device.resolve_device``). Kernels written
by hand for Hopper live in ``repro_torch.kernels``; each has a plain torch
version that CPU tensors take and the tests compare against.
"""
