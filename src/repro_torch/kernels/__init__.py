"""Hand-written CUDA kernels for Hopper, with plain PyTorch versions.

kernels: rmsnorm (fused norm), flash_attention (prefill), decode_attention
(split-S flash decoding), ssd_scan (the Mamba2 SSD scan), each in
``csrc/`` and built by ``_build`` at first use.  See ops.py for the public
wrappers and ref.py for the plain versions.
"""
from . import ops, ref

__all__ = ["ops", "ref"]
