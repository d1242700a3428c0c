"""repro_torch — the DataX serving path ported to PyTorch and CUDA (Hopper).

A package of its own beside the JAX reference ``repro``: it imports torch
and never jax, and nothing of ``repro``.  Module names mirror the
reference's (``configs``, ``kernels``, ``models``, ``serve``).  Entry
points (``models.init``, ``serve.ServeEngine``) run on the card by default
and raise when it is absent; pass ``device="cpu"`` to run on the CPU, where
the kernel wrappers take their plain PyTorch versions.
"""
