"""repro_torch.models.layers vs repro.models.layers, function by function,
on shared inputs (numpy from a seed) and shared parameters (the JAX
package's init, carried across by repro_torch._bridge)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch import _bridge  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

F32 = dict(atol=3e-5, rtol=1e-4)
KEY = jax.random.PRNGKey(0)


def _cfgs(arch="qwen3-14b", **kw):
    kw = dict(param_dtype="float32", activation_dtype="float32", **kw)
    return (dataclasses.replace(jax_smoke(arch), **kw),
            dataclasses.replace(get_smoke_config(arch), **kw))


def _x(shape, seed=0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **(tol or F32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_apply(dtype):
    jx, tx = _x((3, 7, 64))
    jw, tw = _x((64,), seed=1)
    norm = L.RMSNorm(64, getattr(torch, dtype))
    norm.scale.copy_(tw)
    want = JL.rmsnorm_apply({"scale": jw.astype(dtype)}, jx.astype(dtype), 1e-6)
    got = L.rmsnorm_apply(norm, tx.to(getattr(torch, dtype)), 1e-6)
    tol = F32 if dtype == "float32" else dict(atol=5e-2, rtol=5e-2)
    _close(got, want, **tol)


def test_rope_angles_and_apply_rope():
    pos = np.arange(24, dtype=np.int32).reshape(2, 12) * 7
    want_ang = JL.rope_angles(jnp.asarray(pos), 32, 1e6)
    got_ang = L.rope_angles(torch.from_numpy(pos), 32, 1e6)
    _close(got_ang, want_ang, atol=1e-3, rtol=1e-6)
    jx, tx = _x((2, 12, 3, 32))
    _close(L.apply_rope(tx, got_ang), JL.apply_rope(jx, want_ang), atol=1e-5,
           rtol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Sk,H,KH", [(16, 16, 4, 2), (10, 24, 4, 1),
                                        (9, 9, 6, 6)])
def test_naive_and_chunked_attention(Sq, Sk, H, KH, causal):
    jq, tq = _x((2, Sq, H, 16), 1)
    jk, tk = _x((2, Sk, KH, 16), 2)
    jv, tv = _x((2, Sk, KH, 16), 3)
    _close(L.naive_attention(tq, tk, tv, causal=causal),
           JL.naive_attention(jq, jk, jv, causal=causal))
    for chunk in (4, 7, 64):
        _close(L.chunked_attention(tq, tk, tv, causal=causal, chunk=chunk),
               JL.chunked_attention(jq, jk, jv, causal=causal, chunk=chunk))


@pytest.mark.parametrize("lens", [[3, 17], [[1], [32]], 9])
def test_decode_attention(lens):
    jq, tq = _x((2, 8, 16), 1)
    jk, tk = _x((2, 32, 2, 16), 2)
    jv, tv = _x((2, 32, 2, 16), 3)
    want = JL.decode_attention(jq, jk, jv, jnp.asarray(lens))
    got = L.decode_attention(tq, tk, tv, torch.tensor(lens))
    _close(got, want)


@pytest.mark.parametrize("impl", ["naive", "chunked", "pallas"])
def test_attention_qkv_and_apply(impl):
    jcfg, cfg = _cfgs()
    jp = JL.init_attention(KEY, jcfg, jnp.float32)
    attn = _bridge.fill(L.Attention(cfg, torch.float32),
                        jax.tree.map(np.asarray, jp))
    jx, tx = _x((2, 12, cfg.d_model))
    pos = np.broadcast_to(np.arange(12), (2, 12))
    jang = JL.rope_angles(jnp.asarray(pos), cfg.resolved_head_dim,
                          cfg.rope_theta)
    tang = L.rope_angles(torch.from_numpy(pos.copy()), cfg.resolved_head_dim,
                         cfg.rope_theta)
    for got, want in zip(L.attention_qkv(attn, tx, cfg, tang),
                         JL.attention_qkv(jp, jx, jcfg, jang)):
        _close(got, want, atol=1e-4, rtol=1e-4)
    got = L.attention_apply(attn, tx, cfg, angles=tang, impl=impl, chunk=5)
    want = JL.attention_apply(jp, jx, jcfg, angles=jang,
                              impl="chunked" if impl == "pallas" else impl,
                              chunk=5)
    _close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ["qwen3-14b", "granite-34b"])
def test_mlp_apply(arch):
    jcfg, cfg = _cfgs(arch)
    jp = JL.init_mlp(KEY, jcfg, jnp.float32)
    mlp = _bridge.fill(L.MLP(cfg, torch.float32), jax.tree.map(np.asarray, jp))
    jx, tx = _x((2, 5, cfg.d_model))
    _close(L.mlp_apply(mlp, tx, cfg), JL.mlp_apply(jp, jx, jcfg), atol=1e-4,
           rtol=1e-4)


@pytest.mark.parametrize("tie", [False, True])
def test_embed_and_unembed_apply(tie):
    jcfg, cfg = _cfgs(tie_embeddings=tie)
    jp = JL.init_embedding(KEY, jcfg, jnp.float32)
    emb = _bridge.fill(L.Embedding(cfg, torch.float32),
                       jax.tree.map(np.asarray, jp))
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 6))
    got = L.embed_apply(emb, torch.from_numpy(toks), torch.float32)
    for onehot in (False, True):       # the reference's gather and one-hot
        _close(got, JL.embed_apply(jp, jnp.asarray(toks), jnp.float32,
                                   onehot=onehot))
    jx, tx = _x((2, 6, cfg.d_model))
    got = L.unembed_apply(emb, tx)
    assert got.dtype == torch.float32
    _close(got, JL.unembed_apply(jp, jx), atol=1e-5, rtol=1e-4)


def test_bf16_unembedding_is_kept_as_its_f32_values():
    """The untied unembedding is held in f32 (its bf16 values, cast once),
    so logits keep the reference's f32-from-f32-cast numerics."""
    jcfg = jax_smoke("qwen3-14b")
    cfg = get_smoke_config("qwen3-14b")
    jp = JL.init_embedding(KEY, jcfg, jnp.bfloat16)
    emb = _bridge.fill(L.Embedding(cfg, torch.bfloat16),
                       jax.tree.map(np.asarray, jp))
    assert emb.table.dtype == torch.bfloat16
    assert emb.unembed.dtype == torch.float32
    np.testing.assert_array_equal(emb.unembed.numpy(),
                                  np.asarray(jp["unembed"], np.float32))
    jx, tx = _x((1, 3, cfg.d_model))
    _close(L.unembed_apply(emb, tx.to(torch.bfloat16)),
           JL.unembed_apply(jp, jx.astype(jnp.bfloat16)), atol=1e-5, rtol=1e-4)
