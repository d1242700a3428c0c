"""repro_torch.models.mamba2 vs repro.models.mamba2 on mamba2-370m smoke in
f32: the JAX package's params (layer 0's mixer), carried across by
repro_torch._bridge, run through both packages on the same numpy inputs.
The "pallas" impl runs the Pallas SSD kernel in interpret mode on the JAX
side and the port's ssd_scan wrapper (its plain version, on the CPU) on the
port's."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import models as JM  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import mamba2 as JM2  # noqa: E402
from repro_torch import _bridge  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import mamba2 as M2  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-3)


@pytest.fixture(scope="module")
def setup():
    kw = dict(param_dtype="float32", activation_dtype="float32")
    jcfg = dataclasses.replace(jax_smoke("mamba2-370m"), **kw)
    cfg = dataclasses.replace(get_smoke_config("mamba2-370m"), **kw)
    jparams = jax.jit(JM.init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    params = _bridge.load(jax.tree.map(np.asarray, jparams), cfg)
    jmix = jax.tree.map(lambda a: a[0], jparams["layers"]["mixer"])
    return jcfg, cfg, jmix, params.layers[0].mixer, M2.ssm_dims(cfg)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_module_holds_the_reference_keys(setup):
    _, _, jmix, mix, _ = setup
    names = {n for n, _ in mix.named_parameters()}
    keys = {".".join(str(k.key) for k in path)
            for path, _ in jax.tree_util.tree_leaves_with_path(jmix)}
    assert names == keys


def test_causal_conv(setup):
    _, _, jmix, mix, dm = setup
    x = _randn(np.random.default_rng(1), 2, 9, dm["conv_dim"])
    _close(M2.causal_conv(torch.from_numpy(x), mix.conv_w, mix.conv_b),
           JM2.causal_conv(jnp.asarray(x), jmix["conv_w"], jmix["conv_b"]))


def test_conv_step(setup):
    _, _, jmix, mix, dm = setup
    rng = np.random.default_rng(2)
    x = _randn(rng, 3, dm["conv_dim"])
    state = _randn(rng, 3, dm["conv_width"] - 1, dm["conv_dim"])
    out, new = M2.conv_step(torch.from_numpy(x), torch.from_numpy(state),
                            mix.conv_w, mix.conv_b)
    jout, jnew = JM2.conv_step(jnp.asarray(x), jnp.asarray(state),
                               jmix["conv_w"], jmix["conv_b"])
    _close(out, jout)
    _close(new, jnew)


def test_ssd_decode_step(setup):
    _, _, _, _, dm = setup
    rng = np.random.default_rng(3)
    B, H, N, P = 2, dm["nheads"], dm["state"], dm["head_dim"]
    args = (_randn(rng, B, H, N, P), _randn(rng, B, H, P),
            np.log1p(np.exp(_randn(rng, B, H))),
            -np.exp(_randn(rng, H) * 0.5), _randn(rng, B, 1, N),
            _randn(rng, B, 1, N))
    y, state = M2.ssd_decode_step(*map(torch.from_numpy, args))
    jy, jstate = JM2.ssd_decode_step(*map(jnp.asarray, args))
    _close(y, jy)
    _close(state, jstate)


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
@pytest.mark.parametrize("L", [2, 21])            # 2 < conv_width - 1
def test_mamba2_apply_with_state(setup, impl, L):
    jcfg, cfg, jmix, mix, dm = setup
    x = _randn(np.random.default_rng(4), 2, L, cfg.d_model)
    out, (ssm, conv) = M2.mamba2_apply(mix, torch.from_numpy(x), cfg,
                                       impl=impl, return_state=True)
    jout, (jssm, jconv) = jax.jit(
        JM2.mamba2_apply, static_argnames=("cfg", "impl", "return_state"))(
        jmix, jnp.asarray(x), cfg=jcfg, impl=impl, return_state=True)
    _close(out, jout)
    _close(ssm, jssm)
    assert conv.shape == (2, dm["conv_width"] - 1, dm["conv_dim"])
    _close(conv, jconv)
    plain = M2.mamba2_apply(mix, torch.from_numpy(x), cfg, impl=impl)
    torch.testing.assert_close(plain, out, rtol=0, atol=0)


def test_mamba2_decode(setup):
    jcfg, cfg, jmix, mix, dm = setup
    rng = np.random.default_rng(5)
    x = _randn(rng, 3, 1, cfg.d_model)
    ssm = _randn(rng, 3, dm["nheads"], dm["state"], dm["head_dim"])
    conv = _randn(rng, 3, dm["conv_width"] - 1, dm["conv_dim"])
    y, ssm_new, conv_new = M2.mamba2_decode(
        mix, torch.from_numpy(x), cfg, torch.from_numpy(ssm),
        torch.from_numpy(conv))
    jy, jssm, jconv = JM2.mamba2_decode(jmix, jnp.asarray(x), jcfg,
                                        jnp.asarray(ssm), jnp.asarray(conv))
    assert y.shape == (3, 1, cfg.d_model)
    _close(y, jy)
    _close(ssm_new, jssm)
    _close(conv_new, jconv)


def test_decode_continues_the_prefill_state(setup):
    """mamba2_apply's returned (ssm, conv) state seeds mamba2_decode: one
    decode step after an L-token prompt equals position L of the
    (L+1)-token block (the reference's prefill -> decode contract)."""
    _, cfg, _, mix, _ = setup
    x = torch.from_numpy(_randn(np.random.default_rng(6), 2, 12, cfg.d_model))
    full = M2.mamba2_apply(mix, x, cfg, impl="pallas")
    _, (ssm, conv) = M2.mamba2_apply(mix, x[:, :11], cfg, impl="pallas",
                                     return_state=True)
    y, _, _ = M2.mamba2_decode(mix, x[:, 11:], cfg, ssm, conv)
    np.testing.assert_allclose(y[:, 0].numpy(), full[:, 11].numpy(), **TOL)


def test_init_keeps_the_decay_parameters_in_f32():
    cfg = get_smoke_config("mamba2-370m")          # bf16 params
    mix = M2.Mamba2(cfg, torch.bfloat16)
    mix.init_weights(cfg, torch.Generator().manual_seed(0))
    dm = M2.ssm_dims(cfg)
    for name in ("A_log", "D", "dt_bias"):
        assert getattr(mix, name).dtype == torch.float32, name
    assert mix.w_xBC.dtype == torch.bfloat16
    np.testing.assert_allclose(
        torch.exp(mix.A_log).numpy(), np.linspace(1, 16, dm["nheads"]),
        rtol=1e-6)
    assert bool((mix.D == 1).all()) and bool((mix.dt_bias == 0).all())
    assert bool((mix.conv_b == 0).all())
    std = mix.w_z.float().std().item()
    assert abs(std - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
