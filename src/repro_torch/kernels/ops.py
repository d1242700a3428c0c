"""Public wrappers for the hand-written CUDA kernels.

Same signatures as the JAX package's ``kernels/ops.py``.  Each wrapper
takes its plain PyTorch version (``ref.py``) for a tensor that lies on the
CPU, and for a CUDA tensor launches its kernel or raises: there is no
fallback.  Before a launch it checks device, dtype, shape and contiguity;
after it, the C function's ``cudaGetLastError()``.  ``launches`` counts the
kernel launches of each wrapper, so a run can show that it went through
the kernels.
"""
from __future__ import annotations

import math

import torch

from . import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = {"rmsnorm": 0, "flash_attention": 0, "decode_attention": 0,
            "ssd_scan": 0}

DECODE_CHUNK = 128      # cache positions per CTA in decode attention's pass 1
FLASH_MAX_DH = 128
DECODE_MAX_G = 8
RMSNORM_MAX_VECTORS = 2048   # 16-byte vectors per row
SSD_TILE = 64          # positions per tile of the ssd_scan kernel (its kT)
SSD_MAX_NP = 128       # state_dim and head_dim: multiples of 4, at most this


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _on_cpu(*tensors: torch.Tensor) -> bool:
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError(f"tensors must all lie on the CPU or on one CUDA "
                     f"device, got {sorted(str(t.device) for t in tensors)}")


def _check(name: str, *tensors: torch.Tensor) -> int:
    dtype = tensors[0].dtype
    if dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {dtype} is not supported "
                        f"(float32 or bfloat16)")
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name}: mixed dtypes {dtype} and {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    return _DTYPES[dtype]


def _vectors(name: str, D: int, *tensors: torch.Tensor) -> int:
    """D elements as 16-byte vectors; the kernels load rows that way."""
    nbytes = D * tensors[0].element_size()
    if nbytes % 16 or any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: rows of {D} elements must fill whole, "
                         f"16-byte aligned vectors")
    return nbytes // 16


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6):
    """x: [..., D]; w: [D] -> x's shape and dtype."""
    if _on_cpu(x, w):
        return ref.rmsnorm_ref(x, w, eps=eps)
    dt = _check("rmsnorm", x, w)
    D = x.shape[-1]
    if w.shape != (D,):
        raise ValueError(f"rmsnorm: w {tuple(w.shape)} for D={D}")
    y = torch.empty_like(x)
    if _vectors("rmsnorm", D, x, w, y) > RMSNORM_MAX_VECTORS:
        raise ValueError(f"rmsnorm: rows of {D} elements are too long")
    rows = x.numel() // D
    err = _build.library().rt_rmsnorm(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                                      rows, D, eps, dt, _stream(x))
    _raise_on("rmsnorm", err)
    launches["rmsnorm"] += 1
    return y


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True):
    """q: [B, Sq, H, Dh]; k/v: [B, Sk, KH, Dh] -> [B, Sq, H, Dh]."""
    if _on_cpu(q, k, v):
        return ref.flash_attention_ref(q, k, v, causal=causal)
    dt = _check("flash_attention", q, k, v)
    B, Sq, H, Dh = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    if k.shape != (B, Sk, KH, Dh) or v.shape != k.shape or H % KH:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if Dh > FLASH_MAX_DH:
        raise ValueError(f"flash_attention: head_dim {Dh} > {FLASH_MAX_DH}")
    o = torch.empty_like(q)
    if q.dtype == torch.bfloat16 and Dh == 128:         # the tensor-core path
        _vectors("flash_attention", Dh, q, k, v, o)
    err = _build.library().rt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Sq, Sk, H,
        KH, Dh, 1.0 / math.sqrt(Dh), int(causal), dt, _stream(q))
    _raise_on("flash_attention", err)
    launches["flash_attention"] += 1
    return o


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lens: torch.Tensor):
    """q: [B, H, Dh]; caches [B, S, KH, Dh]; lens [B] -> out [B, H, Dh].

    Unlike ``ref.decode_attention_ref``, a row with ``lens[b] == 0`` comes
    out as zeros, as the Pallas kernel gives it."""
    if _on_cpu(q, k_cache, v_cache, lens):
        return ref.decode_attention_ref(q, k_cache, v_cache, lens)
    dt = _check("decode_attention", q, k_cache, v_cache)
    B, H, Dh = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape != (B, S, KH, Dh) or v_cache.shape != k_cache.shape \
            or H % KH or lens.shape != (B,):
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)}, lens {tuple(lens.shape)}")
    G = H // KH
    if G > DECODE_MAX_G:
        raise ValueError(f"decode_attention: {G} q-heads per kv-head > "
                         f"{DECODE_MAX_G}")
    if _vectors("decode_attention", Dh, k_cache, v_cache) not in (4, 8, 16, 32):
        raise ValueError(f"decode_attention: head_dim {Dh} of {q.dtype} is "
                         f"not 4, 8, 16 or 32 16-byte vectors")
    lens = lens.to(torch.int32).contiguous()       # stays on the device
    n_split = -(-S // DECODE_CHUNK)
    f32 = dict(dtype=torch.float32, device=q.device)
    part_acc = torch.empty((B, KH, n_split, G, Dh), **f32)
    part_ml = torch.empty((B, KH, n_split, G, 2), **f32)
    out = torch.empty_like(q)
    err = _build.library().rt_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lens.data_ptr(),
        out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(), B, S, H, KH,
        Dh, DECODE_CHUNK, 1.0 / math.sqrt(Dh), dt, _stream(q))
    _raise_on("decode_attention", err)
    launches["decode_attention"] += 1
    return out


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128,
             block_h: int = 8):
    """Mamba2 SSD scan.  x [B,L,H,P]; dt [B,L,H] f32; A [H] f32; Bm/Cm
    [B,L,1,N] in x's dtype -> (y [B,L,H,P] in x's dtype, final_state
    [B,H,N,P] f32).

    ``chunk`` and ``block_h`` are the TPU kernel's blocking knobs; they do
    not change the function, and the CUDA kernel picks its own tile
    (``SSD_TILE`` positions, one head per CTA).  As the TPU kernel, it
    takes a single B/C group (G = 1).  dt and A stay f32: the decay
    exp(dt·A) must not see them rounded to the activation dtype."""
    del chunk, block_h
    Bsz, L, H, P = x.shape
    if Bm.ndim != 4 or Bm.shape[2] != 1:
        raise ValueError(f"ssd_scan: B/C {tuple(Bm.shape)}: the kernel "
                         f"assumes a single B/C group (G=1)")
    N = Bm.shape[3]
    if dt.shape != (Bsz, L, H) or A.shape != (H,) or \
            Bm.shape != (Bsz, L, 1, N) or Cm.shape != Bm.shape or L < 1:
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(Bm.shape)}, C {tuple(Cm.shape)}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd_scan: dt and A must be float32, got "
                        f"{dt.dtype} and {A.dtype}")
    if _on_cpu(x, dt, A, Bm, Cm):
        return ref.ssd_scan_ref(x, dt, A, Bm, Cm)
    code = _check("ssd_scan", x, Bm, Cm)
    _check("ssd_scan", dt, A)
    if N % 4 or P % 4 or N > SSD_MAX_NP or P > SSD_MAX_NP:
        raise ValueError(f"ssd_scan: state_dim {N} and head_dim {P} must be "
                         f"multiples of 4, at most {SSD_MAX_NP}")
    n_tiles = -(-L // SSD_TILE)
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    final_state = torch.empty((Bsz, H, N, P), **f32)
    states = torch.empty((Bsz, n_tiles, H, N, P), **f32)      # scratch
    segs = torch.empty((Bsz, n_tiles, H), **f32)
    err = _build.library().rt_ssd_scan(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), final_state.data_ptr(),
        states.data_ptr(), segs.data_ptr(), n_tiles, Bsz, L, H, P, N, code,
        _stream(x))
    _raise_on("ssd_scan", err)
    launches["ssd_scan"] += 1
    return y, final_state
