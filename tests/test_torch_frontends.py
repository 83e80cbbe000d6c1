"""The port's stub modality frontends (internvl2-2b's vision, musicgen-
medium's audio) against the reference's.

A frontend is one projection `frontend_proj` [C, D, D] of precomputed
embeddings: vision prepends the projected patches (positions run over
the concatenation, logits cover the text positions), audio adds the
projected frames position by position, in the forward pass and in each
decode step.  The weights are the reference's `init_params` (norms
perturbed), carried across by `convert.lm_params_from_numpy`; the
embeddings are numpy-made and handed to both (the reference's own
`make_lm_batch` draws them with `jax.random`, which torch cannot
reproduce).  Everything is float32.  Tolerances as
`tests/test_torch_lm.py`: logits 5e-5 of their scale (the reference
through its Pallas attention in interpret mode; SEQ + n_patches is one
block), decode steps against the port's own forward 2e-3.  Vision
decoding is skipped, as `tests/test_archs.py` skips it: no decode cache
is primed with patches.
"""
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
from repro_torch import configs, serve_lm
from repro_torch.convert import lm_params_from_numpy

LOGIT_TOL = 5e-5
CHAINS, BATCH, SEQ = 2, 3, 16
ARCHS = ["internvl2-2b", "musicgen-medium"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is faster, and several test
    workers on one machine do not oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close_logits(got, want, tol=LOGIT_TOL):
    want = np.asarray(want)
    scale = max(1.0, float(np.sqrt(np.mean(np.square(want)))))
    np.testing.assert_allclose(got.numpy(), want, atol=tol * scale,
                               rtol=tol)


@functools.lru_cache(maxsize=None)
def _models(name):
    cfg = jconfigs.SMOKES[name]
    rng = np.random.default_rng(11)

    def perturb(path, a):
        leaf = getattr(path[-1], "key", None)
        a = np.asarray(a)
        if leaf in ("norm1", "norm2", "final_norm"):
            return (1.0 + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    tree = jax.tree_util.tree_map_with_path(
        perturb, jinit_params(jax.random.PRNGKey(0), cfg, CHAINS))
    assert "frontend_proj" in tree
    model = lm_params_from_numpy(tree, configs.get_arch(name, smoke=True),
                                 device="cpu")
    return cfg, jax.tree.map(jnp.asarray, tree), model


def _inputs(cfg, seq=SEQ, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (CHAINS, BATCH, seq)).astype(
        np.int32)
    n = cfg.n_patches if cfg.frontend == "vision" else seq
    emb = rng.standard_normal((CHAINS, BATCH, n, cfg.d_model)).astype(
        np.float32)
    return toks, emb


@pytest.mark.parametrize("name", ARCHS)
def test_model_holds_the_count_plus_the_projection(name):
    """The reference's `param_count` leaves out `frontend_proj`, which its
    `init_params` builds: the port's model holds param_count + D² a
    chain."""
    cfg, _, model = _models(name)
    n = sum(p.numel() for p in model.parameters())
    assert n == CHAINS * (cfg.param_count() + cfg.d_model ** 2)
    assert tuple(model.frontend_proj.shape) == (CHAINS, cfg.d_model,
                                                cfg.d_model)


@pytest.mark.parametrize("name", ARCHS)
def test_forward_matches_reference(name):
    cfg, params, model = _models(name)
    toks, emb = _inputs(cfg)
    want, _ = jax.jit(lambda p, t, e: jforward(
        p, {"tokens": t, "embeds": e}, cfg, compute_dtype=jnp.float32,
        use_pallas=True, remat=False))(params, toks, emb)
    got = model(torch.from_numpy(toks), torch.from_numpy(emb),
                compute_dtype=torch.float32)
    assert got.shape == (CHAINS, BATCH, SEQ, cfg.vocab_size)
    _close_logits(got, want)
    last = model(torch.from_numpy(toks), torch.from_numpy(emb),
                 compute_dtype=torch.float32, last_token_only=True)
    assert torch.equal(last, got[:, :, -1:])


def test_vision_patches_change_the_text_logits():
    """The patches are attended to: other patches, other logits (and the
    text alone is a third answer)."""
    cfg, _, model = _models("internvl2-2b")
    toks, emb = _inputs(cfg)
    t = torch.from_numpy(toks)
    a = model(t, torch.from_numpy(emb), compute_dtype=torch.float32)
    b = model(t, torch.from_numpy(emb[:, :, ::-1].copy()),
              compute_dtype=torch.float32)
    c = model(t, compute_dtype=torch.float32)
    assert not torch.allclose(a, b) and not torch.allclose(a, c)


def test_audio_decode_with_frames_matches_reference_and_forward():
    """Decode steps each with its frame's embedding [c, b, 1, D] against
    the reference's decode_step and the port's own forward."""
    cfg, params, model = _models("musicgen-medium")
    steps = 8
    toks, emb = _inputs(cfg, steps, seed=2)
    jstep = jax.jit(lambda p, c, t, e: jdecode_step(
        p, c, {"tokens": t, "embeds": e}, cfg, compute_dtype=jnp.float32,
        use_pallas=True))
    jcache = jinit_cache(cfg, CHAINS, BATCH, max_len=steps,
                         dtype=jnp.float32)
    cache = model.init_cache(BATCH, steps, torch.float32)
    got = []
    for t in range(steps):
        want, jcache = jstep(params, jcache, toks[:, :, t:t + 1],
                             emb[:, :, t:t + 1])
        lg, cache = model.decode_step(
            cache, torch.from_numpy(toks[:, :, t:t + 1]),
            torch.from_numpy(emb[:, :, t:t + 1]),
            compute_dtype=torch.float32)
        _close_logits(lg, want)
        got.append(lg[:, :, 0])
    full = model(torch.from_numpy(toks), torch.from_numpy(emb),
                 compute_dtype=torch.float32)
    np.testing.assert_allclose(torch.stack(got, dim=2).numpy(),
                               full.numpy(), atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("name", ARCHS)
def test_serve_lm_runs_the_frontend_archs(name):
    """`serve_lm --arch` at the smoke size on the CPU: the fused prefill
    takes embeddings of the frontend's shape drawn from --seed."""
    res = serve_lm.main(["--arch", name, "--smoke", "--device", "cpu",
                         "--chains", "2", "--slots", "2", "--prompt-len",
                         "6", "--new-tokens", "3", "--dtype", "f32"])
    cfg = configs.get_arch(name, smoke=True)
    out = np.asarray(res["tokens"])
    assert out.shape == (2, 3) and ((out >= 0) & (out < cfg.vocab_size)).all()
    emb = serve_lm.make_embeds(cfg, 2, 2, 6, 0, "cpu")
    n = cfg.n_patches if cfg.frontend == "vision" else 6
    assert tuple(emb.shape) == (2, 2, n, cfg.d_model)
    assert torch.equal(emb, serve_lm.make_embeds(cfg, 2, 2, 6, 0, "cpu"))
