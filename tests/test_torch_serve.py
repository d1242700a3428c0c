"""repro_torch.serve vs repro.serve: the port's ServeEngine on the CPU emits
the JAX ServeEngine's greedy tokens on the same (bridged) weights, for
qwen3-14b smoke (dense) and mamba2-370m smoke (ssm); slot reuse; slot-table
persistence in the platform's StateStore."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import models as JM  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.configs.base import RunConfig as JaxRun  # noqa: E402
from repro.core.state import StateStore  # noqa: E402
from repro.serve import ServeEngine as JaxEngine  # noqa: E402
from repro_torch import _bridge  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.base import RunConfig  # noqa: E402
from repro_torch.serve import CacheFullError, ServeEngine, SlotAllocator  # noqa: E402
from repro_torch.serve.batcher import ContinuousBatcher, Request  # noqa: E402
from repro_torch.serve.engine import _bucket  # noqa: E402

F32 = dict(param_dtype="float32", activation_dtype="float32")


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jax_smoke("qwen3-14b"), **F32)
    cfg = dataclasses.replace(get_smoke_config("qwen3-14b"), **F32)
    jparams = JM.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jparams, jax.tree.map(np.asarray, jparams)


def _jax_engine_greedy(jcfg, jrun, jparams):
    """The reference engine's greedy tokens (Auto-typed mesh: the default
    mesh's Explicit axes reject its sharding pins under jax >= 0.9)."""
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    eng = JaxEngine(jcfg, jrun, jparams, n_slots=2, max_seq=64, mesh=mesh)
    prompts = _prompts(jcfg.vocab)
    for rid, p in prompts.items():
        eng.submit(rid, p, max_new_tokens=5)
    return {r.request_id: r.generated for r in eng.run_until_idle()}


@pytest.fixture(scope="module")
def jax_greedy(weights):
    jcfg, _, jparams, _ = weights
    return _jax_engine_greedy(
        jcfg, JaxRun(attention_impl="naive", remat="none"), jparams)


def _prompts(vocab):
    return {f"r{i}": [int(t) for t in np.random.default_rng(i).integers(
        1, vocab, 4 + 2 * i)] for i in range(3)}


@pytest.mark.parametrize("impl", ["naive", "chunked", "pallas"])
def test_engine_emits_the_reference_engines_greedy_tokens(weights, jax_greedy,
                                                          impl):
    _, cfg, _, params_np = weights
    eng = ServeEngine(cfg, RunConfig(attention_impl=impl, remat="none",
                                     attention_chunk=4),
                      _bridge.load(params_np, cfg), n_slots=2, max_seq=64,
                      device="cpu")
    for rid, p in _prompts(cfg.vocab).items():
        eng.submit(rid, p, max_new_tokens=5)
    done = eng.run_until_idle()
    assert {r.request_id: r.generated for r in done} == jax_greedy
    assert eng.metrics["prefills"] == 3
    assert eng.metrics["tokens_generated"] == 3 * 4
    assert eng.last_prefill_logits.shape == (cfg.vocab,)


@pytest.fixture(scope="module")
def ssm_weights():
    jcfg = dataclasses.replace(jax_smoke("mamba2-370m"), **F32)
    cfg = dataclasses.replace(get_smoke_config("mamba2-370m"), **F32)
    jparams = jax.jit(JM.init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jparams, jax.tree.map(np.asarray, jparams)


@pytest.mark.parametrize("impl", ["chunked", "pallas"])
def test_ssm_engine_emits_the_reference_engines_greedy_tokens(ssm_weights,
                                                              impl):
    """mamba2: exact-length prefill into a slot's recurrent state, then
    lockstep decode; "pallas" is the Pallas SSD kernel (interpret mode) in
    the reference engine and the port's ssd_scan wrapper here."""
    jcfg, cfg, jparams, params_np = ssm_weights
    want = _jax_engine_greedy(
        jcfg, JaxRun(attention_impl=impl, remat="none"), jparams)
    eng = ServeEngine(cfg, RunConfig(attention_impl=impl, remat="none"),
                      _bridge.load(params_np, cfg), n_slots=2, max_seq=64,
                      device="cpu")
    for rid, p in _prompts(cfg.vocab).items():
        eng.submit(rid, p, max_new_tokens=5)
    done = eng.run_until_idle()
    assert {r.request_id: r.generated for r in done} == want
    assert eng.metrics["prefills"] == 3
    assert eng.slots.n_free == 2


def test_slot_reuse_continuous_batching(weights):
    _, cfg, _, params_np = weights
    eng = ServeEngine(cfg, RunConfig(attention_impl="pallas"),
                      _bridge.load(params_np, cfg), n_slots=2, max_seq=32,
                      device="cpu")
    for i in range(5):  # 5 requests through 2 slots
        eng.submit(f"r{i}", [1 + i, 2, 3], max_new_tokens=3)
    done = eng.run_until_idle()
    assert len(done) == 5
    assert eng.slots.n_free == 2            # all slots returned
    assert all(len(r.generated) == 3 for r in done)


def test_engine_refuses_params_on_another_device(weights):
    _, cfg, _, params_np = weights
    params = _bridge.load(params_np, cfg).to("meta")
    with pytest.raises(ValueError, match="params live on"):
        ServeEngine(cfg, RunConfig(), params, device="cpu")


def test_slot_allocator_exhaustion_and_persistence():
    """The port's allocator persists in the JAX package's StateStore, a
    database it knows only by its ensure_table/scan/put/delete."""
    store = StateStore()
    db = store.create("serving")
    alloc = SlotAllocator(2, db=db)
    alloc.alloc("a")
    alloc.alloc("b")
    with pytest.raises(CacheFullError):
        alloc.alloc("c")
    alloc.free("a")
    alloc.alloc("c")
    # restart: session map recovered from the platform database
    alloc2 = SlotAllocator(2, db=db)
    assert alloc2.n_free == 0
    assert alloc2.slot_of("b") is not None and alloc2.slot_of("c") is not None


def test_batcher_policy_and_buckets():
    b = ContinuousBatcher(n_slots=2, max_prefill_per_tick=1)
    for i in range(3):
        b.submit(Request(request_id=i, prompt=[1], max_new_tokens=1))
    t1 = b.plan_tick(free_slots=2)
    assert len(t1.admit) == 1 and not t1.decode
    t1.admit[0].prefill_done = True
    t1.admit[0].generated = [5]             # done (max_new_tokens=1)
    t2 = b.plan_tick(free_slots=1)
    assert t1.admit[0] in t2.finished
    assert [_bucket(n) for n in (1, 32, 33, 1000, 2049)] == \
        [32, 32, 64, 1024, 4096]
