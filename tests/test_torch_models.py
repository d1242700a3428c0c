"""repro_torch.models vs repro.models in f32, for the dense family on
qwen3-14b smoke and the ssm family on mamba2-370m smoke: the JAX package's
params, carried across by repro_torch._bridge, run through both packages on
the same tokens."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import models as JM  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.configs.base import RunConfig as JaxRun  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import _bridge, models  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-3)
B, S, MAX_SEQ = 2, 10, 24
IMPLS = ["naive", "chunked", "pallas"]


@pytest.fixture(scope="module")
def setup():
    kw = dict(param_dtype="float32", activation_dtype="float32")
    jcfg = dataclasses.replace(jax_smoke("qwen3-14b"), **kw)
    cfg = dataclasses.replace(get_smoke_config("qwen3-14b"), **kw)
    jparams = JM.init(jax.random.PRNGKey(0), jcfg)
    params = _bridge.load(jax.tree.map(np.asarray, jparams), cfg)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (B, S)) \
        .astype(np.int32)
    return jcfg, cfg, jparams, params, tokens


def _runs(impl):
    # the reference's prefill never reaches its Pallas kernel; compare the
    # port's kernels (plain versions here) against its chunked path
    jimpl = "chunked" if impl == "pallas" else impl
    return (JaxRun(attention_impl=jimpl, attention_chunk=4, remat="none"),
            RunConfig(attention_impl=impl, attention_chunk=4, remat="none"))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_logits(setup, impl):
    jcfg, cfg, jparams, params, tokens = setup
    jrun, run = _runs(impl)
    want, _ = JM.forward(jparams, {"tokens": jnp.asarray(tokens)}, jcfg, jrun)
    got, aux = models.forward(params, {"tokens": torch.from_numpy(tokens)},
                              cfg, run)
    _close(got, want)
    assert set(aux) == {"moe_load_balance", "moe_z_loss", "moe_drop_fraction"}
    last, _ = models.forward(params, {"tokens": torch.from_numpy(tokens)},
                             cfg, run, last_only=True)
    _close(last[:, 0], want[:, -1])


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_with_cache_logits_and_cache(setup, impl):
    jcfg, cfg, jparams, params, tokens = setup
    jrun, run = _runs(impl)
    last = np.array([6, 9], np.int32)              # ragged, right-padded
    want, jcache = JT.prefill_with_cache(
        jparams, {"tokens": jnp.asarray(tokens), "last_index": jnp.asarray(last)},
        jcfg, jrun, MAX_SEQ)
    got, cache = T.prefill_with_cache(
        params, {"tokens": torch.from_numpy(tokens),
                 "last_index": torch.from_numpy(last)}, cfg, run, MAX_SEQ)
    _close(got, want)
    for name in ("k", "v"):
        assert cache[name].shape == jcache[name].shape
        for b in range(B):
            n = last[b] + 1                        # compare up to seq_len
            _close(cache[name][:, b, :n], jcache[name][:, b, :n])


def test_prefill_writes_only_its_slot_of_a_pool(setup):
    jcfg, cfg, jparams, params, tokens = setup
    _, run = _runs("pallas")
    pool = models.init_cache(cfg, 3, MAX_SEQ, device="cpu")
    for name in pool:
        pool[name].fill_(7.0)
    _, fresh = T.prefill_with_cache(
        params, {"tokens": torch.from_numpy(tokens[:1])}, cfg, run, MAX_SEQ)
    T.prefill_with_cache(params, {"tokens": torch.from_numpy(tokens[:1])},
                         cfg, run, MAX_SEQ, cache=pool, slot=1)
    for name in pool:
        torch.testing.assert_close(pool[name][:, 1, :S], fresh[name][:, 0, :S])
        assert bool((pool[name][:, 1, S:] == 7).all())    # rows past S kept
        assert bool((pool[name][:, [0, 2]] == 7).all())   # other slots kept


@pytest.mark.parametrize("impl", IMPLS)
def test_decode_step_logits_and_inactive_slots(setup, impl):
    jcfg, cfg, jparams, params, tokens = setup
    jrun, run = _runs(impl)
    jcache = JM.init_cache(jcfg, B, MAX_SEQ)
    cache = models.init_cache(cfg, B, MAX_SEQ, device="cpu")
    for t in range(4):
        active = np.array([True, t % 2 == 0])      # slot 1 idles on odd steps
        seq = np.array([t, t // 2 + t % 2], np.int32)
        want, jcache = JM.decode_step(
            jparams, jcache, {"tokens": jnp.asarray(tokens[:, t:t + 1]),
                              "seq_lens": jnp.asarray(seq),
                              "active": jnp.asarray(active)}, jcfg, jrun)
        before = cache["k"][:, 1].clone()
        got, cache = models.decode_step(
            params, cache, {"tokens": torch.from_numpy(tokens[:, t:t + 1]),
                            "seq_lens": torch.from_numpy(seq),
                            "active": torch.from_numpy(active)}, cfg, run)
        _close(got, want)
        if not active[1]:                          # dropped write: unchanged
            torch.testing.assert_close(cache["k"][:, 1], before, rtol=0, atol=0)
    for name in ("k", "v"):
        _close(cache[name][:, 0, :4], jcache[name][:, 0, :4])


def test_prefill_decode_consistency_dense(setup):
    """Token-by-token decode reproduces the full forward's logits (as
    tests/test_models.py::test_prefill_decode_consistency_dense)."""
    _, cfg, _, params, tokens = setup
    run = RunConfig(attention_impl="naive", remat="none")
    full, _ = models.forward(params, {"tokens": torch.from_numpy(tokens)},
                             cfg, run)
    cache = models.init_cache(cfg, B, 32, device="cpu")
    outs = []
    for t in range(S):
        batch = {"tokens": torch.from_numpy(tokens[:, t:t + 1]),
                 "seq_lens": torch.full((B,), t, dtype=torch.int32)}
        lg, cache = models.decode_step(params, cache, batch, cfg, run)
        outs.append(lg)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               **TOL)


def test_init_is_seeded_and_scaled():
    cfg = get_smoke_config("qwen3-14b")
    a = models.init(3, cfg, device="cpu")
    b = models.init(torch.Generator().manual_seed(3), cfg, device="cpu")
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0, msg=name)
    assert a.embed.table.dtype == torch.bfloat16
    assert a.embed.unembed.dtype == torch.float32
    std = a.layers[0].attn.wq.float().std().item()
    assert abs(std - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    assert bool((a.layers[1].ln1.scale == 1).all())
    n = sum(p.numel() for p in a.parameters())
    assert n == cfg.param_count()


def test_full_config_shapes_without_allocating():
    """qwen3-14b at its published widths: the parameter module's count
    matches the config's analytic count (built on the meta device)."""
    cfg = get_config("qwen3-14b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab) == \
        (40, 5120, 40, 8, 128, 17408, 151936)
    model = T.DenseLM(cfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count()


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "granite-moe-3b-a800m",
                                  "whisper-large-v3"])
def test_families_not_yet_ported_raise(arch):
    cfg = get_smoke_config(arch)
    with pytest.raises(NotImplementedError):
        models.init(0, cfg, device="cpu")
    with pytest.raises(NotImplementedError):
        models.init_cache(cfg, 1, 8, device="cpu")


# ===========================================================================
# ssm family (mamba2-370m smoke)
# ===========================================================================

SSM_IMPLS = ["chunked", "pallas"]


@pytest.fixture(scope="module")
def ssm_setup():
    kw = dict(param_dtype="float32", activation_dtype="float32")
    jcfg = dataclasses.replace(jax_smoke("mamba2-370m"), **kw)
    cfg = dataclasses.replace(get_smoke_config("mamba2-370m"), **kw)
    jparams = jax.jit(JM.init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    params = _bridge.load(jax.tree.map(np.asarray, jparams), cfg)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (B, S)) \
        .astype(np.int32)
    return jcfg, cfg, jparams, params, tokens


def _ssm_runs(impl):
    """The same impl on both sides: "pallas" is the Pallas SSD kernel in
    interpret mode in the reference, the port's ssd_scan wrapper here."""
    return (JaxRun(attention_impl=impl, remat="none"),
            RunConfig(attention_impl=impl, remat="none"))


@pytest.mark.parametrize("impl", SSM_IMPLS)
def test_ssm_forward_logits(ssm_setup, impl):
    jcfg, cfg, jparams, params, tokens = ssm_setup
    jrun, run = _ssm_runs(impl)
    want, _ = jax.jit(JM.forward, static_argnums=(2, 3))(
        jparams, {"tokens": jnp.asarray(tokens)}, jcfg, jrun)
    got, aux = models.forward(params, {"tokens": torch.from_numpy(tokens)},
                              cfg, run)
    _close(got, want)
    assert aux == {}
    last, _ = models.forward(params, {"tokens": torch.from_numpy(tokens)},
                             cfg, run, last_only=True)
    _close(last[:, 0], want[:, -1])


@pytest.mark.parametrize("impl", SSM_IMPLS)
def test_ssm_prefill_with_cache_logits_and_state(ssm_setup, impl):
    jcfg, cfg, jparams, params, tokens = ssm_setup
    jrun, run = _ssm_runs(impl)
    want, jcache = jax.jit(JT.prefill_with_cache, static_argnums=(2, 3, 4))(
        jparams, {"tokens": jnp.asarray(tokens)}, jcfg, jrun, MAX_SEQ)
    pool = models.init_cache(cfg, B + 1, MAX_SEQ, device="cpu")
    got, cache = T.prefill_with_cache(
        params, {"tokens": torch.from_numpy(tokens)}, cfg, run, MAX_SEQ,
        cache=pool, slot=1)
    assert cache is pool
    _close(got, want)
    for name in ("ssm", "conv"):
        assert pool[name].shape[2:] == jcache[name].shape[2:]
        _close(pool[name][:, 1:], jcache[name])
        assert bool((pool[name][:, 0] == 0).all())       # other slot kept


@pytest.mark.parametrize("impl", SSM_IMPLS)
def test_ssm_decode_step_logits_and_state(ssm_setup, impl):
    """Lockstep decode with slot 1 idle on odd steps, from a prefilled
    state, against the reference's decode_step with the same masks."""
    jcfg, cfg, jparams, params, tokens = ssm_setup
    jrun, run = _ssm_runs(impl)
    _, jcache = JT.prefill_with_cache(
        jparams, {"tokens": jnp.asarray(tokens[:, :6])}, jcfg, jrun, MAX_SEQ)
    _, cache = T.prefill_with_cache(
        params, {"tokens": torch.from_numpy(tokens[:, :6])}, cfg, run, MAX_SEQ)
    jstep = jax.jit(JM.decode_step, static_argnums=(3, 4))
    for t in range(6, S):
        active = np.array([True, t % 2 == 0])
        batch = {"tokens": tokens[:, t:t + 1],
                 "seq_lens": np.full((B,), t, np.int32), "active": active}
        want, jcache = jstep(jparams, jcache,
                             {k: jnp.asarray(v) for k, v in batch.items()},
                             jcfg, jrun)
        got, cache = models.decode_step(
            params, cache, {k: torch.from_numpy(v) for k, v in batch.items()},
            cfg, run)
        _close(got, want)
        for name in ("ssm", "conv"):
            _close(cache[name], jcache[name])


def test_ssm_decode_leaves_an_inactive_slots_state_bit_identical(ssm_setup):
    _, cfg, _, params, tokens = ssm_setup
    run = RunConfig(attention_impl="pallas", remat="none")
    _, cache = T.prefill_with_cache(
        params, {"tokens": torch.from_numpy(tokens)}, cfg, run, MAX_SEQ)
    before = {name: t.clone() for name, t in cache.items()}
    batch = {"tokens": torch.from_numpy(tokens[:, :1]),
             "seq_lens": torch.full((B,), S, dtype=torch.int32),
             "active": torch.tensor([True, False])}
    _, after = models.decode_step(params, cache, batch, cfg, run)
    for name in cache:
        torch.testing.assert_close(after[name][:, 1], before[name][:, 1],
                                   rtol=0, atol=0)
        assert not torch.equal(after[name][:, 0], before[name][:, 0])


def test_prefill_decode_consistency_ssm(ssm_setup):
    """Token-by-token decode from an empty state reproduces the full
    forward's logits (as tests/test_models.py does for ssm)."""
    _, cfg, _, params, tokens = ssm_setup
    run = RunConfig(attention_impl="pallas", remat="none")
    full, _ = models.forward(params, {"tokens": torch.from_numpy(tokens)},
                             cfg, run)
    cache = models.init_cache(cfg, B, MAX_SEQ, device="cpu")
    outs = []
    for t in range(S):
        batch = {"tokens": torch.from_numpy(tokens[:, t:t + 1]),
                 "seq_lens": torch.full((B,), t, dtype=torch.int32)}
        lg, cache = models.decode_step(params, cache, batch, cfg, run)
        outs.append(lg)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               **TOL)


def test_ssm_init_is_seeded_and_counts_the_references_params():
    cfg = get_smoke_config("mamba2-370m")
    a = models.init(3, cfg, device="cpu")
    b = models.init(torch.Generator().manual_seed(3), cfg, device="cpu")
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0, msg=name)
    assert a.embed.table.dtype == torch.bfloat16
    assert not hasattr(a.embed, "unembed")                # tied
    assert a.layers[0].mixer.A_log.dtype == torch.float32
    cache = models.init_cache(cfg, 3, 8, device="cpu")
    assert cache["ssm"].dtype == torch.float32
    assert cache["conv"].dtype == torch.bfloat16
    jcfg = jax_smoke("mamba2-370m")
    shapes = jax.eval_shape(lambda k: JM.init(k, jcfg), jax.random.PRNGKey(0))
    assert sum(p.numel() for p in a.parameters()) == \
        sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))


def test_ssm_full_config_shapes_without_allocating():
    """mamba2-370m at its published widths: the parameter module (built on
    the meta device) holds as many values as the reference's init."""
    cfg = get_config("mamba2-370m")
    s = cfg.ssm
    assert (cfg.n_layers, cfg.d_model, s.expand, s.head_dim, s.state_dim,
            s.n_groups, s.conv_width, s.chunk_size, cfg.vocab,
            cfg.tie_embeddings) == (48, 1024, 2, 64, 128, 1, 4, 256, 50280,
                                    True)
    model = T.SSMLM(cfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == 368_338_432
