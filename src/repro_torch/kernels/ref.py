"""Plain PyTorch versions of every kernel (the allclose targets).

Deliberately simple O(S²)/sequential implementations, independent of the
kernels' blocking.  On a CPU tensor the wrappers in ``ops`` run these; on
the card ``chip_smoke.py`` holds each CUDA kernel against them.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -2.0e30


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """q: [B,Sq,H,Dh]; k/v: [B,Sk,KH,Dh] (GQA: H = KH·G)."""
    B, Sq, H, Dh = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    G = H // KH
    qg = q.reshape(B, Sq, KH, G, Dh).float()
    s = torch.einsum("bqkgd,bckd->bqkgc", qg, k.float()) / math.sqrt(Dh)
    if causal:
        mask = (torch.arange(Sk, device=q.device)[None, :]
                > torch.arange(Sq, device=q.device)[:, None])
        s = s.masked_fill(mask[None, :, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bqkgc,bckd->bqkgd", p, v.float())
    return o.reshape(B, Sq, H, Dh).to(q.dtype)


def decode_attention_ref(q, k_cache, v_cache, lens):
    """q: [B,H,Dh]; caches [B,S,KH,Dh]; lens [B].

    A row with ``lens[b] == 0`` comes out as the uniform average of the
    cache (softmax over all-masked scores); the kernel returns zeros there,
    as the Pallas kernel does.  Compare the two only for ``lens >= 1``."""
    B, H, Dh = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    G = H // KH
    qg = q.reshape(B, KH, G, Dh).float() / math.sqrt(Dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float())
    valid = (torch.arange(S, device=q.device)[None, :]
             < lens.reshape(-1, 1).to(q.device))
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return o.reshape(B, H, Dh).to(q.dtype)


def ssd_scan_ref(x, dt, A, Bm, Cm):
    """Sequential state-space recurrence (the SSD ground truth).

    x [B,L,H,P]; dt [B,L,H]; A [H]; Bm/Cm [B,L,G,N].
    Returns (y [B,L,H,P], final_state [B,H,N,P] f32).
    """
    Bsz, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Bh = Bm.float().repeat_interleave(H // G, dim=2)    # [B,L,H,N]
    Ch = Cm.float().repeat_interleave(H // G, dim=2)
    dt = dt.float()
    A = A.float()
    S = torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(L):
        a = torch.exp(dt[:, t] * A)                       # [B,H]
        S = S * a[:, :, None, None] + torch.einsum(
            "bhn,bhp->bhnp", Bh[:, t], x[:, t].float() * dt[:, t, :, None])
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, t], S))
    return torch.stack(ys, dim=1).to(x.dtype), S


def rmsnorm_ref(x, w, *, eps: float = 1e-6):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * w.float()).to(x.dtype)
