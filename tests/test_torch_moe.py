"""The port's MoE (`models.moe`) and the MoE models (phi3.5-moe,
arctic) against the reference's.

The same numpy-made inputs and the reference's own `init_params` /
`init_moe` weights (norms perturbed, as `tests/test_torch_lm.py` does)
go to both packages, the weights carried across by
`convert.lm_params_from_numpy`.  Everything is float32.  Tolerances:
the slot bookkeeping (top-k choices, the slots' sort order, positions
and keep mask) bit-equal; `moe()`'s output 1e-5 (numpy's allclose,
atol = rtol) and its aux loss 1e-6; the models' logits 5e-5 of their
scale (`tests/test_torch_lm.py`'s LOGIT_TOL, the reference through its
Pallas attention in interpret mode, SEQ one block); decode steps
against the port's own forward 2e-3, as `tests/test_archs.py` holds the
reference; greedy generation token for token.  Every config has top-2
routing, where a token's two gated values add in either order to the
same float: the bit-level claims rely on it (asserted).
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
from repro.models import moe as jmoe
from repro.serving import GenerationConfig as JGenerationConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch import configs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import Init
from repro_torch.serving import GenerationConfig, ServingEngine

LOGIT_TOL = 5e-5
MOE_TOL, AUX_TOL = 1e-5, 1e-6
CHAINS, BATCH, SEQ = 2, 3, 16
ARCHS = ["phi3.5-moe-42b-a6.6b", "arctic-480b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is faster, and several test
    workers on one machine do not oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


def _close_logits(got, want):
    want = np.asarray(want)
    scale = max(1.0, float(np.sqrt(np.mean(np.square(want)))))
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_TOL * scale,
                               rtol=LOGIT_TOL)


# ---------------------------------------------------------- moe() alone

def _layer(name, skew):
    """(reference config, reference moe params as numpy, port MoE, input
    x [c, b, s, D] as numpy).  `skew`: capacity factor 1.0, inputs with a
    positive mean and the router's expert-0 column raised, so that every
    token's first choice is expert 0 and half of its slots drop."""
    cfg = jconfigs.SMOKES[name]
    if skew:
        cfg = dataclasses.replace(cfg, capacity_factor=1.0)
    assert cfg.moe_top_k == 2
    params = jax.tree.map(np.asarray, jmoe.init_moe(
        jax.random.PRNGKey(5), cfg, CHAINS, jnp.float32))
    rng = np.random.default_rng(6)
    x = rng.standard_normal((CHAINS, BATCH, SEQ, cfg.d_model)).astype(
        np.float32)
    if skew:
        x += 1.0
        params["router"] = params["router"].copy()
        params["router"][:, :, 0] += 0.5
    flat = {}
    for k, v in params.items():
        if isinstance(v, dict):
            flat.update({f"{k}.{kk}": vv for kk, vv in v.items()})
        else:
            flat[k] = v
    pcfg = configs.get_arch(name, smoke=True)
    if skew:
        pcfg = dataclasses.replace(pcfg, capacity_factor=1.0)
    layer = tmoe.MoE(pcfg, CHAINS, torch.float32, Init("cpu"))
    layer.load_state_dict({k: torch.from_numpy(np.array(v))
                          for k, v in flat.items()})
    return cfg, params, layer, x


def _reference_slots(params, x, cfg):
    """The reference `moe`'s routing and slot bookkeeping, line for line
    (its function returns only y and aux)."""
    c, b, s, D = x.shape
    E, K = cfg.n_experts, cfg.moe_top_k
    T = b * s
    C = jmoe._capacity(T, cfg)
    xt = jnp.asarray(x).reshape(c, T, D)
    logits = jnp.einsum("ctd,cde->cte", xt.astype(jnp.float32),
                        jnp.asarray(params["router"]))
    probs = jax.nn.softmax(logits, axis=-1)
    gate, eidx = jax.lax.top_k(probs, K)
    slot_e = eidx.reshape(c, T * K)
    order = jnp.argsort(slot_e, axis=-1)
    sorted_e = jnp.take_along_axis(slot_e, order, axis=-1)
    pos = jnp.arange(T * K)[None, :] - jax.vmap(
        lambda se: jnp.searchsorted(se, se, side="left"))(sorted_e)
    return [np.asarray(a) for a in (eidx, order, sorted_e, pos, pos < C)]


@pytest.mark.parametrize("skew", [False, True], ids=["smoke", "drops"])
@pytest.mark.parametrize("name", ARCHS)
def test_slot_bookkeeping_is_the_references_bit_for_bit(name, skew):
    cfg, params, layer, x = _layer(name, skew)
    eidx, order, sorted_e, pos, keep = _reference_slots(params, x, cfg)
    c, b, s, D = x.shape
    cap = tmoe.capacity(b * s, layer.cfg)
    assert cap == jmoe._capacity(b * s, cfg)
    _, _, got_eidx = tmoe.route(torch.from_numpy(x).reshape(c, b * s, D),
                                layer.router, cfg.moe_top_k)
    got = tmoe.slots(got_eidx, cap)
    np.testing.assert_array_equal(got_eidx.numpy(), eidx)
    for g, w in zip(got, (order, sorted_e, pos, keep)):
        np.testing.assert_array_equal(g.numpy(), w)
    dropped = 1.0 - keep.mean()
    assert (dropped > 0.2) if skew else dropped == 0.0
    with tmoe.moe_drops(layer) as shares:
        layer(torch.from_numpy(x), torch.float32)
    assert shares == [pytest.approx(dropped)]
    assert layer.drops is None


@pytest.mark.parametrize("skew", [False, True], ids=["smoke", "drops"])
@pytest.mark.parametrize("name", ARCHS)
def test_moe_output_and_aux_match_the_reference(name, skew):
    """With drops, a dropped slot adds zeros at position C_e - 1 of its
    expert, where a kept token may sit: the port adds, as the reference
    does, and does not overwrite it."""
    cfg, params, layer, x = _layer(name, skew)
    want_y, want_aux = jax.jit(lambda p, x: jmoe.moe(
        p, x, cfg, jnp.float32))(jax.tree.map(jnp.asarray, params), x)
    y, aux = layer(torch.from_numpy(x), torch.float32)
    _close(y, want_y, MOE_TOL)
    _close(aux, want_aux, AUX_TOL)


def test_capacity_is_the_references():
    for name in ARCHS:
        for cfg in (jconfigs.ARCHS[name], jconfigs.SMOKES[name]):
            for t in (1, 8, 200, 1600, 4096):
                assert tmoe.capacity(t, configs.get_arch(
                    name, smoke="smoke" in cfg.name)) == \
                    jmoe._capacity(t, cfg)


def test_top_k_ties_go_to_the_lower_expert():
    """Equal router probabilities: the first K experts, as jax.lax.top_k
    picks them."""
    router = torch.zeros((1, 4, 6))
    _, gate, eidx = tmoe.route(torch.ones((1, 3, 4)), router, 2)
    assert eidx.tolist() == [[[0, 1]] * 3]
    assert torch.equal(gate, torch.full((1, 3, 2), 0.5))


# --------------------------------------------------------------- models

@functools.lru_cache(maxsize=None)
def _models(name, chains=CHAINS):
    cfg = jconfigs.SMOKES[name]
    assert cfg.moe_top_k == 2
    rng = np.random.default_rng(11)

    def perturb(path, a):
        leaf = getattr(path[-1], "key", None)
        a = np.asarray(a)
        if leaf in ("norm1", "norm2", "final_norm"):
            return (1.0 + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    tree = jax.tree_util.tree_map_with_path(
        perturb, jinit_params(jax.random.PRNGKey(0), cfg, chains))
    model = lm_params_from_numpy(tree, configs.get_arch(name, smoke=True),
                                 device="cpu")
    return cfg, jax.tree.map(jnp.asarray, tree), model


def _tokens(vocab, shape, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


@pytest.mark.parametrize("name", ARCHS)
def test_model_holds_the_configs_parameter_count(name):
    cfg, _, model = _models(name)
    n = sum(p.numel() for p in model.parameters())
    assert n == CHAINS * cfg.param_count()
    port = configs.get_arch(name, smoke=True)
    assert port.active_param_count() == cfg.active_param_count()


@pytest.mark.parametrize("name", ARCHS)
def test_forward_and_aux_match_reference(name):
    cfg, params, model = _models(name)
    toks = _tokens(cfg.vocab_size, (CHAINS, BATCH, SEQ))
    want, want_aux = jax.jit(lambda p, t: jforward(
        p, {"tokens": t}, cfg, compute_dtype=jnp.float32, use_pallas=True,
        remat=False))(params, toks)
    got, aux = model(torch.from_numpy(toks), compute_dtype=torch.float32,
                     with_aux=True)
    _close_logits(got, want)
    _close(aux, want_aux, AUX_TOL)
    last = model(torch.from_numpy(toks), compute_dtype=torch.float32,
                 last_token_only=True)
    assert torch.equal(last, got[:, :, -1:])


@pytest.mark.parametrize("name", ARCHS)
def test_decode_steps_match_reference_and_forward(name):
    """Decode steps (T = b tokens: capacity 8, no drop) against the
    reference's decode_step and against the port's own forward (whose
    smoke capacity factor of 8 drops nothing either)."""
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
        _close_logits(lg, want)
        got.append(lg[:, :, 0])
    full = model(torch.from_numpy(toks), compute_dtype=torch.float32)
    np.testing.assert_allclose(torch.stack(got, dim=2).numpy(),
                               full.numpy(), atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("name", ARCHS)
def test_greedy_generate_matches_reference(name):
    cfg, params, model = _models(name, 3)
    prompts = _tokens(cfg.vocab_size, (3, 4), seed=3)
    jeng = JServingEngine(cfg, params, n_chains=3, batch_slots=3,
                          max_len=16, gen=JGenerationConfig(
                              max_new_tokens=6, combine="simple"))
    eng = ServingEngine(model, batch_slots=3, max_len=16,
                        gen=GenerationConfig(max_new_tokens=6,
                                             combine="simple"))
    want = np.asarray(jeng.generate(jnp.asarray(prompts)))
    got = eng.generate(torch.from_numpy(prompts)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ARCHS)
def test_serve_lm_reports_the_fused_prefills_drop_share(name):
    """`serve_lm --arch` at the smoke size on the CPU: one drop share for
    each MoE layer of the fused prefill, all 0 at the smoke configs'
    capacity factor 8."""
    from repro_torch import serve_lm
    res = serve_lm.main(["--arch", name, "--smoke", "--device", "cpu",
                         "--chains", "2", "--slots", "2", "--prompt-len",
                         "6", "--new-tokens", "2", "--dtype", "f32"])
    assert res["moe_drop_share"] == 0.0
    cfg = configs.get_arch(name, smoke=True)
    assert ((np.asarray(res["tokens"]) >= 0)
            & (np.asarray(res["tokens"]) < cfg.vocab_size)).all()
