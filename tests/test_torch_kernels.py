"""repro_torch kernels' plain versions vs the JAX package's Pallas kernels
(interpret mode, as tests/test_kernels.py runs them) and jnp oracles.

The algorithms are compared in f32 against both; bf16 cases are held to
the jnp oracles (which the Pallas kernels meet at the same tolerance in
tests/test_kernels.py), sparing an interpret-mode compile per case.

The CUDA kernels themselves run only on the card; chip_smoke.py holds each
against these plain versions there.  Inputs are made with numpy from a seed
and handed to both packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import mamba2 as jmamba2  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import mamba2  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(rng, shape, dtype: str):
    """The same values as a jax array and a CPU tensor (bf16 rounded once,
    from the same f32 numbers, in both)."""
    x = rng.standard_normal(shape).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _tol(dtype: str):
    return dict(atol=5e-2, rtol=5e-2) if dtype == "bfloat16" \
        else dict(atol=3e-5, rtol=1e-4)


def _pallas(dtype: str, fn, *args, **kw):
    return fn(*args, **kw) if dtype == "float32" else None


def _check(got, pallas, oracle, dtype: str) -> None:
    for want in (pallas, oracle):
        if want is not None:
            np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,H,KH,Dh,bq,bk,causal", [
    (1, 64, 64, 4, 4, 32, 32, 32, True),      # MHA square
    (2, 128, 128, 8, 2, 64, 64, 64, True),    # GQA
    (1, 96, 96, 4, 1, 32, 32, 32, True),      # MQA, ragged blocks
    (2, 64, 128, 4, 2, 16, 64, 64, False),    # cross-attn (non-causal)
    (1, 200, 200, 2, 2, 64, 64, 64, True),    # non-divisible seq (padding)
])
def test_flash_attention_plain_matches_pallas(B, Sq, Sk, H, KH, Dh, bq, bk,
                                              causal, dtype):
    rng = np.random.default_rng(7)
    jq, tq = _pair(rng, (B, Sq, H, Dh), dtype)
    jk, tk = _pair(rng, (B, Sk, KH, Dh), dtype)
    jv, tv = _pair(rng, (B, Sk, KH, Dh), dtype)
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    pallas = _pallas(dtype, jops.flash_attention, jq, jk, jv, causal=causal,
                     block_q=bq, block_k=bk)
    oracle = jref.flash_attention_ref(jq, jk, jv, causal=causal)
    _check(got, pallas, oracle, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KH,Dh,bs", [
    (2, 128, 8, 2, 64, 64),
    (1, 300, 4, 1, 32, 128),                  # MQA + padding
    (3, 64, 4, 4, 16, 32),                    # MHA
    (4, 96, 10, 2, 32, 32),                   # G = 5, as qwen3-14b
])
def test_decode_attention_plain_matches_pallas(B, S, H, KH, Dh, bs, dtype):
    rng = np.random.default_rng(11)
    jq, tq = _pair(rng, (B, H, Dh), dtype)
    jk, tk = _pair(rng, (B, S, KH, Dh), dtype)
    jv, tv = _pair(rng, (B, S, KH, Dh), dtype)
    lens = rng.integers(1, S + 1, B).astype(np.int32)     # lens >= 1 only
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(lens))
    pallas = _pallas(dtype, jops.decode_attention, jq, jk, jv,
                     jnp.asarray(lens), block_s=bs)
    oracle = jref.decode_attention_ref(jq, jk, jv, jnp.asarray(lens))
    _check(got, pallas, oracle, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 32, 128), (100, 96), (3, 5, 7, 64),
                                   (6, 5120)])
def test_rmsnorm_plain_matches_pallas(shape, dtype):
    rng = np.random.default_rng(3)
    jx, tx = _pair(rng, shape, dtype)
    jw, tw = _pair(rng, shape[-1:], dtype)
    got = ops.rmsnorm(tx, tw, eps=1e-6)
    pallas = _pallas(dtype, jops.rmsnorm, jx, jw, eps=1e-6, block_rows=16)
    oracle = jref.rmsnorm_ref(jx, jw, eps=1e-6)
    _check(got, pallas, oracle, dtype)


@pytest.mark.parametrize("B,L,H,P,N,G", [
    (1, 64, 8, 16, 16, 1),
    (2, 37, 4, 32, 64, 1),
    (1, 24, 4, 8, 16, 2),                     # grouped B/C (oracle only)
])
def test_ssd_scan_ref_matches_jax_oracle(B, L, H, P, N, G):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
    Bm = rng.standard_normal((B, L, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, L, G, N)).astype(np.float32)
    y, fs = ref.ssd_scan_ref(*map(torch.from_numpy, (x, dt, A, Bm, Cm)))
    yr, fsr = jref.ssd_scan_ref(*map(jnp.asarray, (x, dt, A, Bm, Cm)))
    np.testing.assert_allclose(_np(y), _np(yr), atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(_np(fs), _np(fsr), atol=2e-3, rtol=2e-3)


def _ssd_inputs(rng, B, L, H, P, N, G=1):
    """f32 SSD inputs as numpy: dt from softplus, A < 0 (as the layer)."""
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
    Bm = rng.standard_normal((B, L, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, L, G, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("B,L,H,P,N,chunk,bh", [
    (1, 64, 8, 16, 16, 16, 4),
    (2, 100, 16, 32, 64, 32, 8),              # padding tail
    (1, 48, 4, 64, 128, 16, 4),               # big state
])
def test_ssd_scan_plain_matches_pallas(B, L, H, P, N, chunk, bh):
    """The port's wrapper on CPU tensors (its plain version) against the
    Pallas kernel in interpret mode, at tests/test_kernels.py's shapes:
    both outputs, f32."""
    args = _ssd_inputs(np.random.default_rng(13), B, L, H, P, N)
    ops.reset_launches()
    y, fs = ops.ssd_scan(*map(torch.from_numpy, args), chunk=chunk,
                         block_h=bh)
    assert ops.launches["ssd_scan"] == 0
    assert y.shape == (B, L, H, P) and y.dtype == torch.float32
    assert fs.shape == (B, H, N, P) and fs.dtype == torch.float32
    yj, fsj = jops.ssd_scan(*map(jnp.asarray, args), chunk=chunk, block_h=bh)
    np.testing.assert_allclose(_np(y), _np(yj), atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(_np(fs), _np(fsj), atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("B,L,H,P,N,G,chunk", [
    (1, 64, 8, 16, 16, 1, 16),
    (2, 37, 4, 8, 16, 2, 8),                  # grouped B/C, padding tail
])
def test_ssd_chunked_matches_jax(B, L, H, P, N, G, chunk, with_init):
    rng = np.random.default_rng(17)
    args = _ssd_inputs(rng, B, L, H, P, N, G)
    init = rng.standard_normal((B, H, N, P)).astype(np.float32) \
        if with_init else None
    y, fs = mamba2.ssd_chunked(
        *map(torch.from_numpy, args), chunk=chunk,
        init_state=None if init is None else torch.from_numpy(init))
    yj, fsj = jmamba2.ssd_chunked(
        *map(jnp.asarray, args), chunk=chunk,
        init_state=None if init is None else jnp.asarray(init))
    np.testing.assert_allclose(_np(y), _np(yj), atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(_np(fs), _np(fsj), atol=2e-3, rtol=2e-3)


def test_ssd_scan_wrapper_refuses_what_the_kernel_does_not_take():
    x, dt, A, Bm, Cm = map(torch.from_numpy,
                           _ssd_inputs(np.random.default_rng(0), 1, 8, 4, 8, 16))
    with pytest.raises(TypeError, match="dt and A must be float32"):
        ops.ssd_scan(x, dt.to(torch.bfloat16), A, Bm, Cm)
    with pytest.raises(ValueError, match="single B/C group"):
        ops.ssd_scan(x, dt, A, Bm.expand(1, 8, 2, 16), Cm.expand(1, 8, 2, 16))
    with pytest.raises(ValueError, match="ssd_scan: x"):
        ops.ssd_scan(x, dt[:, :4], A, Bm, Cm)


def test_cpu_tensors_take_the_plain_path_without_launching():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 2, 8, 16)).astype(np.float32))
    kv = torch.from_numpy(rng.standard_normal((4, 8, 2, 16)).astype(np.float32))
    ops.reset_launches()
    torch.testing.assert_close(ops.rmsnorm(x, x[0, 0, 0], eps=1e-6),
                               ref.rmsnorm_ref(x, x[0, 0, 0], eps=1e-6),
                               rtol=0, atol=0)
    torch.testing.assert_close(ops.flash_attention(x.transpose(1, 2).contiguous(),
                                                   kv, kv, causal=True),
                               ref.flash_attention_ref(
                                   x.transpose(1, 2).contiguous(), kv, kv),
                               rtol=0, atol=0)
    lens = torch.tensor([1, 3, 8, 5], dtype=torch.int32)
    torch.testing.assert_close(ops.decode_attention(x[:, 0], kv, kv, lens),
                               ref.decode_attention_ref(x[:, 0], kv, kv, lens),
                               rtol=0, atol=0)
    args = [torch.from_numpy(a) for a in _ssd_inputs(rng, 2, 9, 4, 8, 16)]
    for got, want in zip(ops.ssd_scan(*args), ref.ssd_scan_ref(*args)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert ops.launches == {"rmsnorm": 0, "flash_attention": 0,
                            "decode_attention": 0, "ssd_scan": 0}


def test_wrappers_refuse_tensors_off_cpu_and_cuda():
    x = torch.empty((4, 16), device="meta")
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        ops.rmsnorm(x, torch.empty((16,), device="meta"))
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        ops.rmsnorm(torch.ones((4, 16)), torch.empty((16,), device="meta"))
