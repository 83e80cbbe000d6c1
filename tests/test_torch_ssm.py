"""The port's SSD scan (B6's plain version), Mamba-2 mixer and the SSM and
hybrid models against the reference.

The same numpy-made inputs go to both packages; the reference's Pallas
SSD kernel runs in interpret mode under `jax.jit`, as
`tests/test_kernels.py` runs it.  Everything is float32.  Tolerances
(numpy's allclose, atol = rtol): the scan 2e-4, the reference's own
(`tests/test_kernels.py`); the models' logits 5e-5 of their scale, as
`tests/test_torch_lm.py` holds the dense ones (`_close_logits`); the
mixer 1e-5 (one layer); decode steps against the port's own forward 2e-3 (the
recurrence against the chunked scan: rounding only).  Greedy generation
is compared token for token.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.models import ssm as jssm
from repro.serving import GenerationConfig as JGenerationConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch import configs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import ops, ref, ssd_scan
from repro_torch.models.layers import Init
from repro_torch.models.ssm import Mamba, init_ssm_cache
from repro_torch.serving import GenerationConfig, ServingEngine

SSD_TOL = 2e-4
LOGIT_TOL = 5e-5
CHAINS, BATCH, SEQ = 2, 3, 16
ARCHS = ["mamba2-1.3b", "zamba2-2.7b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is faster, and several test
    workers on one machine do not oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


def _close_logits(got, want):
    """LOGIT_TOL of the logits' scale: atol grows with their root mean
    square where it exceeds 1.  The untied heads of the dense models give
    logits of rms about 1; mamba2's tied table (Normal(0, 1) rows) gives
    rms about sqrt(d_model), where summation order alone moves a logit
    near 0 by more than 5e-5."""
    want = np.asarray(want)
    scale = max(1.0, float(np.sqrt(np.mean(np.square(want)))))
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_TOL * scale,
                               rtol=LOGIT_TOL)


def _ssd_inputs(seed, c, b, s, h, p, n, a_scale=1.0):
    """x, dt, A, B, C as numpy float32, chain axis leading; A·dt scaled
    by `a_scale`."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = (0.5 * rng.standard_normal((c, b, s, h, p))).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((c, b, s, h)))).astype(f)
    A = (-a_scale * np.exp(0.3 * rng.standard_normal((c, h)))).astype(f)
    B = (0.5 * rng.standard_normal((c, b, s, n))).astype(f)
    C = (0.5 * rng.standard_normal((c, b, s, n))).astype(f)
    return x, dt, A, B, C


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


# ------------------------------------------------------------------- scan

@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (1, 64, 2, 8, 8, 16),
    (2, 128, 4, 16, 8, 32),
    (1, 96, 1, 32, 16, 32),      # s not a power of two
    (1, 50, 2, 8, 8, 16),        # s not a chunk multiple (pads)
    (1, 50, 2, 8, 8, 64),        # s < chunk: one chunk of s
    (1, 1, 2, 8, 8, 64),         # one step
    (1, 200, 2, 8, 8, 64),       # the prefill's 200 steps: 3 chunks + 8
])
def test_plain_ssd_matches_the_reference_kernel_and_oracle(b, s, h, p, n,
                                                           chunk):
    """The grid of `tests/test_kernels.py` and the ragged cases, with a
    leading chain axis of 2: the reference vmaps its Pallas `ops.ssd`
    over the chains as its Mamba layer does."""
    arrays = _ssd_inputs(3, CHAINS, b, s, h, p, n)
    want = jax.jit(jax.vmap(functools.partial(jops.ssd, chunk=chunk)))(
        *map(jnp.asarray, arrays))
    got = ops.ssd(*_torch(arrays), chunk=chunk)
    _close(got, want, SSD_TOL)
    _close(got, jax.vmap(jref.ref_ssd)(*map(jnp.asarray, arrays)), SSD_TOL)
    _close(ref.ref_ssd(*_torch(arrays)), want, SSD_TOL)


def test_ssd_decode_step_stepped_over_s_equals_the_scan():
    arrays = _ssd_inputs(4, CHAINS, 2, 32, 2, 8, 8)
    x, dt, A, B, C = _torch(arrays)
    state = torch.zeros((CHAINS, 2, 2, 8, 8))
    ys = []
    for t in range(x.shape[2]):
        state, y = ops.ssd_decode_step(state, x[:, :, t], dt[:, :, t], A,
                                       B[:, :, t], C[:, :, t])
        ys.append(y)
    _close(torch.stack(ys, 2), ops.ssd(x, dt, A, B, C).numpy(), SSD_TOL)


def test_ssd_stays_finite_where_the_masked_exponent_overflows():
    """A·dt of about -250 a step: above the diagonal exp(cum_t - cum_s)
    is +inf, which the chunk algebra must select away, not multiply by a
    0/1 mask (inf·0 = NaN)."""
    arrays = _ssd_inputs(5, 1, 2, 128, 2, 8, 8, a_scale=200.0)
    x, dt, A, B, C = _torch(arrays)
    cum = (A[:, None, None, :] * dt)[:, :, :64].cumsum(2)
    assert torch.isinf((cum[:, :, -1] - cum[:, :, 0]).neg().exp()).any()
    got = ops.ssd(x, dt, A, B, C)
    assert got.isfinite().all()
    _close(got, ref.ref_ssd(x, dt, A, B, C).numpy(), SSD_TOL)


def test_ssd_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA route launches its kernel or raises: handed CPU tensors,
    the wrapper tries to build for a card there is none of, and does not
    fall back to the plain version."""
    x, dt, A, B, C = _torch(_ssd_inputs(6, 1, 1, 8, 2, 4, 4))
    with pytest.raises(RuntimeError, match="CUDA"):
        ssd_scan.ssd_scan_cuda(x, dt, A, B, C)
    with pytest.raises(ValueError, match="state"):
        ssd_scan.ssd_scan_cuda(x, dt, A, B, C, chunk=65)


# ------------------------------------------------------------------ mixer

def _perturb(rng):
    """The reference's init leaves norms at 1 and A_log, dt_bias and the
    conv biases at 0: random values there exercise the chain-axis
    weights and the biases."""
    def fn(path, a):
        leaf = getattr(path[-1], "key", None)
        a = np.asarray(a)
        if leaf in ("norm1", "norm2", "final_norm", "out_norm"):
            return (1.0 + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        if leaf in ("A_log", "dt_bias", "conv_b_x", "conv_b_bc"):
            return (0.3 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return fn


@functools.lru_cache(maxsize=None)
def _mixer():
    cfg = jconfigs.SMOKES["mamba2-1.3b"]
    params = jax.tree_util.tree_map_with_path(
        _perturb(np.random.default_rng(12)),
        jssm.init_mamba(jax.random.PRNGKey(1), cfg, CHAINS, jnp.float32))
    mixer = Mamba(configs.get_arch("mamba2-1.3b", smoke=True), CHAINS,
                  torch.float32, Init("cpu"))
    mixer.load_state_dict({k: torch.from_numpy(np.array(a))
                           for k, a in params.items()})
    return cfg, jax.tree.map(jnp.asarray, params), mixer


def test_mamba_mixer_matches_the_reference_full_and_cached():
    """The full-sequence route (conv, B6's plain version, gated norm) and
    8 cached one-token steps against `repro.models.ssm.mamba`."""
    cfg, params, mixer = _mixer()
    x = np.random.default_rng(13).standard_normal(
        (CHAINS, BATCH, SEQ, cfg.d_model)).astype(np.float32)
    want, _ = jax.jit(lambda p, x: jssm.mamba(
        p, x, cfg, compute_dtype=jnp.float32, use_pallas=True))(params, x)
    got, none = mixer(torch.from_numpy(x), compute_dtype=torch.float32)
    assert none is None
    _close(got, want, 1e-5)

    jstep = jax.jit(lambda p, x, c: jssm.mamba(
        p, x, cfg, cache=c, compute_dtype=jnp.float32))
    jcache = jssm.init_ssm_cache(cfg, CHAINS, BATCH, jnp.float32)
    cache = init_ssm_cache(mixer.cfg, CHAINS, BATCH, torch.float32, "cpu")
    for t in range(8):
        w, jcache = jstep(params, x[:, :, t:t + 1], jcache)
        g, cache = mixer(torch.from_numpy(x[:, :, t:t + 1]), cache,
                         compute_dtype=torch.float32)
        _close(g, w, 1e-5)
        _close(g, got[:, :, t:t + 1].numpy(), 2e-3)
    for key in ("conv_x", "conv_bc", "ssm"):
        _close(cache[key], jcache[key], 1e-5)


# ----------------------------------------------------------------- models

@functools.lru_cache(maxsize=None)
def _models(name, chains=CHAINS):
    """(reference config, reference params tree as numpy, port model) on
    the same weights."""
    cfg = jconfigs.SMOKES[name]
    tree = jax.tree_util.tree_map_with_path(
        _perturb(np.random.default_rng(11)),
        jinit_params(jax.random.PRNGKey(0), cfg, chains))
    model = lm_params_from_numpy(tree, configs.get_arch(name, smoke=True),
                                 device="cpu")
    return cfg, tree, model


def _tokens(vocab, shape, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


@pytest.mark.parametrize("name", ARCHS)
def test_conversion_carries_every_leaf(name):
    """Every leaf of the reference's tree, `layers.i.mamba.*` and the
    hybrid's `shared.*` among them, lands in the port's parameter of the
    same name, and nothing else is there."""
    cfg, tree, model = _models(name)
    leaves = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path): np.asarray(a)
              for path, a in jax.tree_util.tree_leaves_with_path(tree)}
    leaves["embed"] = leaves.pop("embed.table")
    state = model.state_dict()
    assert sorted(state) == sorted(leaves)
    for key, a in leaves.items():
        np.testing.assert_array_equal(state[key].numpy(), a, err_msg=key)
    # the config's count (the reference's formula) leaves out the conv
    # biases, d_inner + 2·N per 'M' layer, which both trees hold
    conv_b = cfg.pattern.count("M") * (cfg.d_inner + 2 * cfg.ssm_state)
    assert sum(p.numel() for p in model.parameters()) == \
        CHAINS * (cfg.param_count() + conv_b)
    if cfg.shared_attn_every:
        assert any(k.startswith("shared.attn.") for k in state)


@pytest.mark.parametrize("name", ARCHS)
def test_forward_and_decode_steps_match_reference(name):
    """Logits of `forward` (the reference's Pallas SSD in interpret mode)
    and of 8 cached decode steps against the reference's, and the decode
    steps against the port's own forward; `last_token_only` is the last
    row of the full logits (up to the GEMM's rounding at one row)."""
    cfg, tree, model = _models(name)
    params = jax.tree.map(jnp.asarray, tree)
    toks = _tokens(cfg.vocab_size, (CHAINS, BATCH, SEQ))
    want = jax.jit(lambda p, t: jforward(
        p, {"tokens": t}, cfg, compute_dtype=jnp.float32, use_pallas=True,
        remat=False)[0])(params, toks)
    full = model(torch.from_numpy(toks), compute_dtype=torch.float32)
    _close_logits(full, want)
    last = model(torch.from_numpy(toks), compute_dtype=torch.float32,
                 last_token_only=True)
    _close_logits(last, full[:, :, -1:].numpy())

    steps = 8
    jstep = jax.jit(lambda p, c, t: jdecode_step(
        p, c, {"tokens": t}, cfg, compute_dtype=jnp.float32,
        use_pallas=True))
    jcache = jinit_cache(cfg, CHAINS, BATCH, max_len=steps,
                         dtype=jnp.float32)
    cache = model.init_cache(BATCH, steps, torch.float32)
    assert len(cache.get("shared", [])) == len(jcache.get("shared", []))
    for t in range(steps):
        w, jcache = jstep(params, jcache, toks[:, :, t:t + 1])
        g, cache = model.decode_step(
            cache, torch.from_numpy(toks[:, :, t:t + 1]),
            compute_dtype=torch.float32)
        _close_logits(g, w)
        _close(g, full[:, :, t:t + 1].numpy(), 2e-3)


# ---------------------------------------------------------------- serving

PROMPTS = _tokens(512, (3, 4), seed=3)
WEIGHTS = [1.0, 0.5, 2.0]


def _engines(name, combine):
    cfg, tree, model = _models(name, 3)
    params = jax.tree.map(jnp.asarray, tree)
    jeng = JServingEngine(cfg, params, n_chains=3, batch_slots=3, max_len=16,
                          chain_weights=WEIGHTS,
                          gen=JGenerationConfig(max_new_tokens=6,
                                                combine=combine))
    eng = ServingEngine(model, batch_slots=3, max_len=16,
                        chain_weights=WEIGHTS,
                        gen=GenerationConfig(max_new_tokens=6,
                                             combine=combine))
    return jeng, eng


@functools.lru_cache(maxsize=None)
def _reference_tokens(name, combine, drop=None):
    jeng, _ = _engines(name, combine)
    if drop is not None:
        jeng.drop_chain(drop)
    return np.asarray(jeng.generate(jnp.asarray(PROMPTS)))


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("combine,drop", [("simple", 1), ("weighted", 2)])
def test_greedy_generate_matches_reference_with_a_dropped_chain(name,
                                                                combine,
                                                                drop):
    """Greedy tokens equal the reference's healthy, with a chain dropped,
    and again once it is revived."""
    _, eng = _engines(name, combine)

    def generate():
        eng.reset()
        return eng.generate(torch.from_numpy(PROMPTS)).numpy()
    out = generate()
    assert out.shape == (3, 6) and out.dtype == np.int32
    np.testing.assert_array_equal(out, _reference_tokens(name, combine))
    eng.drop_chain(drop)
    np.testing.assert_array_equal(generate(),
                                  _reference_tokens(name, combine, drop))
    eng.revive_chain(drop, WEIGHTS[drop])
    np.testing.assert_array_equal(generate(), out)
