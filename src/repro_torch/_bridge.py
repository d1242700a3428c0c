"""Carry a JAX-package parameter pytree (as numpy arrays) into the port.

The reference stacks each layer's parameters along a leading ``L`` axis
(``params["layers"]["attn"]["wq"]`` is ``[L, D, H*Dh]``); the port holds
one module per layer.  ``load`` walks the port module's parameter names
(``layers.3.attn.wq``) and takes slice 3 of the stacked leaf.  bf16 arrays
(numpy's ``bfloat16`` extension dtype) cross through a ``uint16`` view,
since ``torch.from_numpy`` does not take them.  Used by the tests, so that
both packages run the same weights.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T


def to_tensor(a, device="cpu") -> torch.Tensor:
    """numpy array (any dtype numpy holds, bfloat16 included) -> tensor."""
    a = np.array(a, copy=True, order="C")     # writable, owned by torch
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def _leaf(params: dict, name: str):
    parts = name.split(".")
    layer = None
    if parts[0] == "layers":
        layer, parts = int(parts[1]), ["layers"] + parts[2:]
    node = params
    for p in parts:
        node = node[p]
    return node if layer is None else np.asarray(node)[layer]


@torch.no_grad()
def fill(module: nn.Module, params: dict) -> nn.Module:
    """Copy ``params``' values into ``module``'s parameters, by name."""
    for name, p in module.named_parameters():
        src = to_tensor(_leaf(params, name))
        if src.shape != p.shape:
            raise ValueError(f"{name}: {tuple(src.shape)} != {tuple(p.shape)}")
        p.copy_(src)                  # casts, e.g. bf16 unembed -> f32 copy
    return module


_MODULES = {"dense": T.DenseLM, "ssm": T.SSMLM}


def load(params: dict, cfg: ModelConfig, *, device="cpu") -> nn.Module:
    """The port's parameter module for ``cfg`` holding ``params``' values."""
    if cfg.family not in _MODULES:
        raise NotImplementedError(f"the {cfg.family!r} family is not ported "
                                  f"to repro_torch yet")
    return fill(_MODULES[cfg.family](cfg, device=T.resolve_device(device)),
                params)
