"""The port's dense LM and serving engine against the reference's.

Each model's parameters come from the reference's `init_params` (norm
weights and QKV biases then set to random values, so that the chain-axis
weights and the biases are exercised), carried across by
`convert.lm_params_from_numpy`.  Everything is float32.  Tolerances
(numpy's allclose, atol = rtol): the port's logits against the
reference's 5e-5 (summation order over a few layers); decode steps against
the port's own forward 2e-3, as `tests/test_archs.py` holds the reference.
Greedy generation is compared token for token.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.serving import GenerationConfig as JGenerationConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch import configs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.serving import GenerationConfig, ServingEngine, sample_token

LOGIT_TOL = 5e-5
CHAINS, BATCH, SEQ = 2, 3, 16
# qwen3: GQA with qk_norm; internlm2: plain GQA; qwen2.5: QKV bias and the
# stacked (scan_layers) parameter layout
ARCHS = ["qwen3-1.7b", "internlm2-1.8b", "qwen2.5-32b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is faster, and several test
    workers on one machine do not oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _models(name, chains=CHAINS):
    """(reference config, reference params, port model) on the same
    weights."""
    cfg = jconfigs.SMOKES[name]
    rng = np.random.default_rng(11)

    def perturb(path, a):
        leaf = getattr(path[-1], "key", None)
        a = np.asarray(a)
        if leaf in ("norm1", "norm2", "q_norm", "k_norm", "final_norm"):
            return (1.0 + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        if leaf in ("bq", "bk", "bv"):
            return (0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    tree = jax.tree_util.tree_map_with_path(
        perturb, jinit_params(jax.random.PRNGKey(0), cfg, chains))
    model = lm_params_from_numpy(tree, configs.get_arch(name, smoke=True),
                                 device="cpu")
    return cfg, jax.tree.map(jnp.asarray, tree), model


def _tokens(vocab, shape, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _close(got, want, tol=LOGIT_TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


# ------------------------------------------------------------ configs

@pytest.mark.parametrize("name", sorted(configs.ARCHS))
def test_config_tables_copy_the_reference(name):
    for smoke in (False, True):
        port = configs.get_arch(name, smoke=smoke)
        ref = jconfigs.get_arch(name, smoke=smoke)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert (port.hd, port.pattern, port.param_count(),
                port.active_param_count(), port.attention_free,
                port.sub_quadratic) == (
            ref.hd, ref.pattern, ref.param_count(),
            ref.active_param_count(), ref.attention_free, ref.sub_quadratic)
    assert configs.RUNS[name] == jconfigs.RUNS[name]


def test_unported_archs_raise():
    """Every architecture of the reference's registry is in the port's,
    full and smoke; an unknown name raises KeyError."""
    assert sorted(configs.ARCHS) == sorted(jconfigs.ARCHS)
    assert sorted(configs.SMOKES) == sorted(jconfigs.SMOKES)
    for name in jconfigs.ARCHS:
        assert configs.get_arch(name).name == name
        assert configs.get_arch(name, smoke=True).n_layers <= 6
    assert not hasattr(configs, "NOT_PORTED")
    with pytest.raises(KeyError):
        configs.get_arch("no-such-arch")
    with pytest.raises(KeyError):
        configs.get_arch("no-such-arch", smoke=True)


# ------------------------------------------------------------- models

@pytest.mark.parametrize("name", ARCHS)
def test_model_holds_the_configs_parameter_count(name):
    cfg, _, model = _models(name)
    n = sum(p.numel() for p in model.parameters())
    assert n == CHAINS * cfg.param_count()


@pytest.mark.parametrize("name", ARCHS)
def test_forward_matches_reference(name):
    """Logits against the reference's forward through its Pallas
    attention (interpret mode; SEQ is one block, so its route is right);
    `last_token_only` is the last row of the full logits."""
    cfg, params, model = _models(name)
    toks = _tokens(cfg.vocab_size, (CHAINS, BATCH, SEQ))
    want = jax.jit(lambda p, t: jforward(
        p, {"tokens": t}, cfg, compute_dtype=jnp.float32, use_pallas=True,
        remat=False)[0])(params, toks)
    got = model(torch.from_numpy(toks), compute_dtype=torch.float32)
    _close(got, want)
    last = model(torch.from_numpy(toks), compute_dtype=torch.float32,
                 last_token_only=True)
    assert torch.equal(last, got[:, :, -1:])


@pytest.mark.parametrize("name", ARCHS)
def test_decode_steps_match_reference_and_forward(name):
    """8 cached decode steps against the reference's decode_step (Pallas
    attention with kv_len, interpret mode) and against the port's own
    forward over the same tokens."""
    cfg, params, model = _models(name)
    steps = 8
    toks = _tokens(cfg.vocab_size, (CHAINS, BATCH, steps), seed=2)
    jstep = jax.jit(lambda p, c, t: jdecode_step(
        p, c, {"tokens": t}, cfg, compute_dtype=jnp.float32,
        use_pallas=True))
    jcache = jinit_cache(cfg, CHAINS, BATCH, max_len=steps,
                         dtype=jnp.float32)
    cache = model.init_cache(BATCH, steps, torch.float32)
    got = []
    for t in range(steps):
        want, jcache = jstep(params, jcache, toks[:, :, t:t + 1])
        lg, cache = model.decode_step(
            cache, torch.from_numpy(toks[:, :, t:t + 1]),
            compute_dtype=torch.float32)
        _close(lg, want)
        got.append(lg[:, :, 0])
    full = model(torch.from_numpy(toks), compute_dtype=torch.float32)
    _close(torch.stack(got, dim=2), full.numpy(), 2e-3)


# ------------------------------------------------------------ serving

PROMPTS = _tokens(512, (3, 4), seed=3)
WEIGHTS = [1.0, 0.5, 2.0]


def _engines(combine, chains=3, **gen):
    cfg, params, model = _models("qwen3-1.7b", chains)
    jeng = JServingEngine(cfg, params, n_chains=chains, batch_slots=3,
                          max_len=16, chain_weights=WEIGHTS[:chains],
                          gen=JGenerationConfig(max_new_tokens=6,
                                                combine=combine, **gen))
    eng = ServingEngine(model, batch_slots=3, max_len=16,
                        chain_weights=WEIGHTS[:chains],
                        gen=GenerationConfig(max_new_tokens=6,
                                             combine=combine, **gen))
    return jeng, eng


def _generate(eng, prompts=PROMPTS):
    if isinstance(eng, JServingEngine):
        return np.asarray(eng.generate(jnp.asarray(prompts)))
    return eng.generate(torch.from_numpy(prompts)).numpy()


@functools.lru_cache(maxsize=None)
def _reference_tokens(combine, drop=None, eos_id=-1):
    jeng, _ = _engines(combine, eos_id=eos_id)
    if drop is not None:
        jeng.drop_chain(drop)
    return _generate(jeng)


@pytest.mark.parametrize("combine", ["simple", "weighted", "none"])
def test_greedy_generate_matches_reference(combine):
    _, eng = _engines(combine)
    out = _generate(eng)
    assert out.shape == (3, 6) and out.dtype == np.int32
    np.testing.assert_array_equal(out, _reference_tokens(combine))


@pytest.mark.parametrize("combine,drop", [("simple", 1), ("weighted", 2),
                                          ("none", 0)])
def test_dropped_and_revived_chain_match_reference(combine, drop):
    """A dropped chain leaves the mix (for "none", the next alive chain
    serves) exactly as the reference's drop does; reviving it restores
    the healthy output."""
    _, eng = _engines(combine)
    eng.drop_chain(drop)
    cut = _generate(eng)
    np.testing.assert_array_equal(cut, _reference_tokens(combine, drop))
    assert not np.array_equal(cut, _reference_tokens(combine))
    eng.revive_chain(drop, WEIGHTS[drop])
    eng.reset()
    np.testing.assert_array_equal(_generate(eng),
                                  _reference_tokens(combine))


def test_eos_freezes_slots_and_stops_early():
    """A slot that emits eos_id is frozen at eos, the others run on
    unchanged, as the reference's engine does; once every slot is done the
    loop stops."""
    healthy = _reference_tokens("simple")
    eos = int(healthy[0, 1])
    _, eng = _engines("simple", eos_id=eos)
    out = _generate(eng)
    np.testing.assert_array_equal(out, _reference_tokens("simple",
                                                         eos_id=eos))
    for b in range(out.shape[0]):
        hits = np.flatnonzero(healthy[b] == eos)
        j = hits[0] if hits.size else out.shape[1]
        np.testing.assert_array_equal(out[b, :j + 1], healthy[b, :j + 1])
        assert (out[b, j + 1:] == eos).all()

    same = np.repeat(PROMPTS[:1], 3, axis=0)          # every slot alike
    first = int(_generate(_engines("simple")[1], same)[0, 0])
    _, eng = _engines("simple", eos_id=first)
    steps = [0]
    inner = eng._decode

    def counted(*a):
        steps[0] += 1
        return inner(*a)
    eng._decode = counted
    out = _generate(eng, same)
    assert (out == first).all() and steps[0] == 1


# ------------------------------------------------------------ sampling

def test_sample_token_greedy_takes_the_first_maximum():
    logits = torch.tensor([[1.0, 5.0, 2.0, 5.0]])
    assert sample_token(logits).tolist() == [1]


def test_sample_token_topk_ties_keep_exactly_k():
    """Three tied maxima under top_k = 2: only the two lowest indices."""
    logits = torch.tensor([[5.0, 5.0, 5.0, 0.0, 0.0]])
    g = torch.Generator().manual_seed(1)
    seen = {int(sample_token(logits, 1.0, 2, g)[0]) for _ in range(64)}
    assert seen == {0, 1}


def test_sample_token_topk_overflow_equals_plain_sampling():
    logits = torch.tensor([[1.0, 3.0, 2.0, 0.5, -1.0]])
    for seed in range(8):
        over = sample_token(logits, 1.0, 12,
                            torch.Generator().manual_seed(seed))
        plain = sample_token(logits, 1.0, 0,
                             torch.Generator().manual_seed(seed))
        assert torch.equal(over, plain)


def test_sample_token_topk_respects_support():
    logits = torch.tensor([[10.0, 9.0, -5.0, -5.0, -5.0]] * 4)
    g = torch.Generator().manual_seed(0)
    for _ in range(8):
        assert set(sample_token(logits, 1.0, 2, g).tolist()) <= {0, 1}


@pytest.mark.parametrize("loss", [[2.30, float("nan"), 2.31],
                                  [2.30, 2.28, 45.0]])
def test_quarantine_unhealthy_matches_reference(loss):
    """The serving-side health cut (a NaN probe loss, a robust-z outlier)
    zeroes the same chains' weights as the reference's, and generation
    after it serves the same tokens."""
    jeng, eng = _engines("weighted")
    j_rep = jeng.quarantine_unhealthy(jnp.asarray(loss, jnp.float32))
    rep = eng.quarantine_unhealthy(loss)
    np.testing.assert_array_equal(rep["alive"].numpy(),
                                  np.asarray(j_rep["alive"]))
    np.testing.assert_array_equal(eng.chain_weights.numpy(),
                                  np.asarray(jeng.chain_weights))
    assert float(eng.chain_weights.min()) == 0.0
    np.testing.assert_array_equal(_generate(eng), _generate(jeng))
