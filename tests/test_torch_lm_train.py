"""LM training in the port (`models.loss_fn`, `launch.steps`,
`launch.train`) against the reference's, on the CPU in float32.

The port starts from the reference's own weights (its `init_params`,
carried across by `convert.lm_params_from_numpy(trainable=True)`) and
optimizer state (`convert.opt_state_from_numpy`), both packages on the
same synthetic stream (`make_lm_batch`, whose tokens are the same bit
for bit).  Tolerances: the loss and its parts 1e-6 (float32, summation
order); one train step's loss 1e-5, its per-chain gradient norm 1e-4
relative and the parameters after it 1e-5 (numpy's allclose, atol =
rtol); a 10-step loss curve 1e-3 (ten steps of AdamW amplify rounding);
gradient accumulation against one batch 1e-4, as
`tests/test_train_integration.py` holds the reference.  The port's own
restart and chain independence are exact.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import sharding as jsharding
from repro.launch.steps import make_decode_step as jmake_decode_step
from repro.launch.steps import make_prefill_step as jmake_prefill_step
from repro.launch.steps import make_train_step as jmake_train_step
from repro.launch.train import make_lm_batch as jmake_lm_batch
from repro.launch.train import train as jtrain
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.models import layers as jlayers
from repro.models import loss_fn as jloss_fn
from repro.optim import OptConfig as JOptConfig
from repro.optim import init_opt_state as jinit_opt_state
from repro_torch import configs
from repro_torch.convert import lm_params_from_numpy, opt_state_from_numpy
from repro_torch.kernels import flash_attention, rmsnorm, ssd_scan
from repro_torch.launch.sharding import DistConfig
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.launch.train import make_lm_batch, train
from repro_torch.models import cross_entropy, init_params, loss_fn
from repro_torch.optim import OptConfig, init_opt_state
from repro_torch.tree import leaves_with_paths

CHAINS = 2
F32 = dict(compute_dtype="float32", remat=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().float().numpy()


@functools.lru_cache(maxsize=None)
def _reference_init(name, seed=0, chains=CHAINS):
    return jax.tree.map(np.asarray, jinit_params(
        jax.random.PRNGKey(seed), jconfigs.SMOKES[name], chains))


def _port_model(name, seed=0, chains=CHAINS):
    return lm_params_from_numpy(_reference_init(name, seed, chains),
                                configs.get_arch(name, smoke=True),
                                device="cpu", trainable=True)


def _batch(name, step=0, batch=2, seq=16, chains=CHAINS):
    """The same batch for both packages: tokens from the shared stream;
    a frontend's embeddings the reference's (jax.random), handed to the
    port."""
    cfg = jconfigs.SMOKES[name]
    jb = jmake_lm_batch(0, step, cfg, chains, batch, seq)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    port = make_lm_batch(0, step, configs.get_arch(name, smoke=True), chains,
                         batch, seq)
    for k in ("tokens", "targets"):
        assert torch.equal(port[k], tb[k])
    return jb, tb


def _leaves(tree):
    return jax.tree.leaves(tree)


# ------------------------------------------------------------------ loss

def test_cross_entropy_matches_the_reference():
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((2, 3, 5, 40))).astype(np.float32)
    targets = rng.integers(0, 40, (2, 3, 5)).astype(np.int32)
    for z in (0.0, 1e-4):
        want = jlayers.cross_entropy(jnp.asarray(logits),
                                     jnp.asarray(targets), z)
        got = cross_entropy(torch.from_numpy(logits),
                            torch.from_numpy(targets), z)
        assert got.shape == (2,) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name", ["internlm2-1.8b", "phi3.5-moe-42b-a6.6b",
                                  "arctic-480b", "musicgen-medium",
                                  "internvl2-2b", "mamba2-1.3b"])
def test_loss_fn_matches_the_reference(name):
    """Cross-entropy plus router_aux_weight · aux for MoE; a frontend's
    embeddings go in."""
    cfg = jconfigs.SMOKES[name]
    jb, tb = _batch(name)
    want = jax.jit(lambda p, b: jloss_fn(
        p, b, cfg, compute_dtype=jnp.float32, use_pallas=False,
        remat=False))(_reference_init(name), jb)
    model = _port_model(name)
    got = loss_fn(model, tb, compute_dtype=torch.float32, use_kernels=False)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
    if cfg.is_moe:
        _, aux = model(tb["tokens"], compute_dtype=torch.float32,
                       use_kernels=False, with_aux=True)
        assert float(aux.detach().min()) > 0.0


def test_remat_keeps_loss_and_gradients():
    """Checkpointed layers ("full", "dots") recompute the same numbers on
    the CPU: the loss and every gradient equal the plain run's."""
    _, tb = _batch("phi3.5-moe-42b-a6.6b")
    grads = {}
    for remat in (False, "full", "dots"):
        model = _port_model("phi3.5-moe-42b-a6.6b")
        loss = loss_fn(model, tb, compute_dtype=torch.float32,
                       use_kernels=False, remat=remat)
        loss.sum().backward()
        grads[remat] = (loss.detach(), [p.grad for p in model.parameters()])
    for remat in ("full", "dots"):
        assert torch.equal(grads[remat][0], grads[False][0])
        for a, b in zip(grads[remat][1], grads[False][1]):
            assert torch.equal(a, b)


# ------------------------------------------------------------ train step

@pytest.mark.parametrize("name", ["internlm2-1.8b", "phi3.5-moe-42b-a6.6b",
                                  "musicgen-medium"])
def test_train_steps_match_the_reference(name):
    """Two steps: the first from the reference's initial weights, the
    second from the port's state after the first; then the reference's
    state after both carried across (`opt_state_from_numpy`).

    The gradients are held to the reference's on each leaf's scale (atol
    1e-5 of its largest element, rtol 1e-4).  The learning rate is 1e-4:
    AdamW's first steps move each parameter by about lr · g / (|g| +
    eps), whatever |g|, so a gradient element at the eps scale (1e-8,
    the float32 remainder of sums that cancel, which summation order
    moves by some per cent) moves the parameter by up to 3e-5 more or
    less at lr 1e-3 (measured on these smoke models): a property of
    AdamW in float32, which the 1e-5 bound on the parameters would read
    as a fault."""
    cfg = jconfigs.SMOKES[name]
    opt = dict(lr=1e-4, warmup_steps=1, total_steps=10)
    dist = jsharding.DistConfig(n_chains=CHAINS, **F32)
    jstep = jax.jit(jmake_train_step(cfg, dist, JOptConfig(**opt)))
    jgrad = jax.jit(jax.grad(lambda p, b: jloss_fn(
        p, b, cfg, compute_dtype=jnp.float32, use_pallas=False,
        remat=False).sum()))
    step = make_train_step(configs.get_arch(name, smoke=True), DistConfig(
        n_chains=CHAINS, **F32), OptConfig(**opt))
    jp = jax.tree.map(jnp.asarray, _reference_init(name))
    js = jinit_opt_state(jp, JOptConfig(**opt))
    model = _port_model(name)
    state = init_opt_state(model.param_tree(), OptConfig(**opt))
    for i in range(2):
        jb, tb = _batch(name, step=i)
        loss = loss_fn(model, tb, compute_dtype=torch.float32,
                       use_kernels=False)
        loss.sum().backward()
        for (_, p), g in zip(leaves_with_paths(model.param_tree()),
                             _leaves(jgrad(jp, jb))):
            g = np.asarray(g)
            np.testing.assert_allclose(_np(p.grad), g, rtol=1e-4,
                                       atol=1e-5 * np.abs(g).max())
        jp, js, jm = jstep(jp, js, jb)
        model, state, m = step(model, state, tb)
        np.testing.assert_allclose(_np(m["loss"]), np.asarray(jm["loss"]),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(_np(m["grad_norm"]),
                                   np.asarray(jm["grad_norm"]), rtol=1e-4)
        for a, b in zip(_leaves(model.param_tree()), _leaves(jp)):
            np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-5,
                                       rtol=1e-5)
        assert m["loss"].shape == (CHAINS,) and int(state["step"]) == i + 1
    carried = opt_state_from_numpy(jax.tree.map(np.asarray, js), model)
    assert int(carried["step"]) == 2
    for k in ("m", "v"):
        for a, b in zip(_leaves(carried[k]), _leaves(js[k])):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(_np(a), np.asarray(b))


def test_accumulation_matches_one_batch():
    """accum_steps=2 over the batch split [C, B] → [A, C, B/A] against
    one step over the whole batch, and against the reference's
    accumulation."""
    name = "qwen3-1.7b"
    cfg = configs.get_arch(name, smoke=True)
    opt = OptConfig(lr=1e-3, warmup_steps=0, clip_norm=1e9)
    _, tb = _batch(name, batch=8)
    out = {}
    for a in (1, 2):
        model = _port_model(name)
        state = init_opt_state(model.param_tree(), opt)
        step = make_train_step(cfg, DistConfig(n_chains=CHAINS,
                                               accum_steps=a, **F32), opt)
        model, _, m = step(model, state, tb)
        out[a] = (m["loss"], [p.detach() for p in model.parameters()])
    np.testing.assert_allclose(_np(out[2][0]), _np(out[1][0]), rtol=1e-5)
    for x, y in zip(out[1][1], out[2][1]):
        np.testing.assert_allclose(_np(x), _np(y), atol=1e-4, rtol=1e-4)
    jb, _ = _batch(name, batch=8)
    jopt = JOptConfig(lr=1e-3, warmup_steps=0, clip_norm=1e9)
    jp = jax.tree.map(jnp.asarray, _reference_init(name))
    jp2, _, jm = jax.jit(jmake_train_step(
        jconfigs.SMOKES[name], jsharding.DistConfig(
            n_chains=CHAINS, accum_steps=2, **F32), jopt))(
        jp, jinit_opt_state(jp, jopt), jb)
    np.testing.assert_allclose(_np(out[2][0]), np.asarray(jm["loss"]),
                               atol=1e-5, rtol=1e-5)
    for a, b in zip(_leaves(nest_of(out[2][1], name)), _leaves(jp2)):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-4,
                                   rtol=1e-4)


def nest_of(params, name):
    """A model's parameter list in `param_tree`'s layout."""
    model = _port_model(name)
    with torch.no_grad():
        for p, q in zip(model.parameters(), params):
            p.copy_(q)
    return model.param_tree()


def test_chains_never_mix_during_training():
    """Perturbing chain 1's batch leaves chain 0's loss and parameters
    bit-equal."""
    name = "internlm2-1.8b"
    cfg = configs.get_arch(name, smoke=True)
    opt = OptConfig(lr=1e-2, warmup_steps=0)
    _, tb = _batch(name)
    other = dict(tb)
    other["tokens"] = tb["tokens"].clone()
    other["tokens"][1] = (other["tokens"][1] + 7) % cfg.vocab_size
    runs = []
    for b in (tb, other):
        model = _port_model(name)
        state = init_opt_state(model.param_tree(), opt)
        step = make_train_step(cfg, DistConfig(n_chains=CHAINS, **F32), opt)
        for _ in range(2):
            model, state, m = step(model, state, b)
        runs.append((m["loss"], [p.detach() for p in model.parameters()]))
    assert runs[0][0][0] == runs[1][0][0]
    assert runs[0][0][1] != runs[1][0][1]
    for x, y in zip(runs[0][1], runs[1][1]):
        assert torch.equal(x[0], y[0])


# --------------------------------------------------------------- trainer

KW = dict(smoke=True, batch=2, seq=16, chains=CHAINS, lr=1e-3,
          log_every=100, schedule_steps=10)


def test_ten_step_loss_curve_matches_the_reference():
    _, _, want = jtrain("internlm2-1.8b", steps=10, **KW)
    _, _, got = train("internlm2-1.8b", steps=10, device="cpu",
                      model=_port_model("internlm2-1.8b"), **KW)
    assert got.shape == (10, CHAINS)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
    assert (got[-3:].mean(0) < got[:3].mean(0)).all()


def test_restart_is_bitwise_deterministic(tmp_path):
    """10 steps straight against 6, a restart from the step-6 checkpoint,
    and 4 more: the same losses bit for bit."""
    _, _, full = train("qwen3-1.7b", steps=10, device="cpu", **KW)
    train("qwen3-1.7b", steps=6, device="cpu", ckpt_dir=str(tmp_path),
          save_interval=6, **KW)
    _, state, tail = train("qwen3-1.7b", steps=10, device="cpu",
                           ckpt_dir=str(tmp_path), resume=True,
                           save_interval=100, **KW)
    np.testing.assert_array_equal(full[6:], tail)
    assert state["step"].ndim == 0 and int(state["step"]) == 10


def test_resume_continues_a_checkpoint_the_reference_wrote(tmp_path):
    """The reference trains 6 steps and checkpoints; the port resumes
    from its files (params and AdamW state, the step counter back to a
    scalar) and trains 4 more, on the reference's curve."""
    _, _, want = jtrain("internlm2-1.8b", steps=10, **KW)
    jtrain("internlm2-1.8b", steps=6, ckpt_dir=str(tmp_path),
           save_interval=6, **KW)
    _, state, tail = train("internlm2-1.8b", steps=10, device="cpu",
                           ckpt_dir=str(tmp_path), resume=True,
                           save_interval=100, **KW)
    assert int(state["step"]) == 10 and state["step"].ndim == 0
    np.testing.assert_allclose(tail, want[6:], atol=1e-3, rtol=1e-3)


def test_decode_step_combines_as_the_reference():
    name = "qwen3-1.7b"
    cfg = jconfigs.SMOKES[name]
    jp = jax.tree.map(jnp.asarray, _reference_init(name))
    model = _port_model(name)
    model.requires_grad_(False)
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (CHAINS, 3, 1)).astype(np.int32)
    w = np.float32([1.0, 3.0])
    for combine in ("none", "simple", "weighted"):
        jdist = jsharding.DistConfig(n_chains=CHAINS, use_pallas=True, **F32)
        want, _ = jax.jit(jmake_decode_step(cfg, jdist, combine))(
            jp, jinit_cache(cfg, CHAINS, 3, 8, jnp.float32),
            {"tokens": toks, "chain_weights": w})
        step = make_decode_step(configs.get_arch(name, smoke=True),
                                DistConfig(n_chains=CHAINS, use_kernels=True,
                                           **F32), combine)
        got, _ = step(model, model.init_cache(3, 8, torch.float32),
                      {"tokens": torch.from_numpy(toks),
                       "chain_weights": torch.from_numpy(w)})
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("name", ["qwen3-1.7b", "internvl2-2b"])
def test_prefill_step_matches_the_reference(name):
    """One forward pass over the prompts (with a frontend's embeddings),
    all positions and the last one only."""
    cfg = jconfigs.SMOKES[name]
    jb, tb = _batch(name)
    jp = jax.tree.map(jnp.asarray, _reference_init(name))
    model = _port_model(name)
    model.requires_grad_(False)
    for last in (False, True):
        jdist = jsharding.DistConfig(n_chains=CHAINS, use_pallas=True,
                                     opt_prefill_last_only=last, **F32)
        want = jax.jit(jmake_prefill_step(cfg, jdist))(jp, jb)
        got = make_prefill_step(configs.get_arch(name, smoke=True),
                                DistConfig(n_chains=CHAINS, use_kernels=True,
                                           opt_prefill_last_only=last,
                                           **F32))(model, tb)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=5e-5, rtol=5e-5)


def test_dist_config_is_the_references():
    """The port's DistConfig holds every field of the reference's, with
    its defaults (`use_kernels` for `use_pallas`): since the sharding
    rules came, each has a reader; a step refuses a batch whose chain
    count is not `n_chains`."""
    port = {f.name: f.default for f in dataclasses.fields(DistConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(
        jsharding.DistConfig)}
    assert port.pop("use_kernels") is False and ref.pop("use_pallas") is False
    assert port == ref
    cfg = configs.get_arch("internlm2-1.8b", smoke=True)
    model = init_params(cfg, CHAINS, device="cpu")
    toks = torch.zeros((CHAINS + 1, 1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="n_chains"):
        make_prefill_step(cfg, DistConfig(n_chains=CHAINS, **F32))(
            model, {"tokens": toks})


# --------------------------------------------------------------- refusal

def test_kernel_wrappers_refuse_operands_that_require_grad():
    """The CUDA kernels have no backward: each wrapper raises on an
    operand with requires_grad before it builds or launches anything,
    and counts no launch."""
    q = torch.randn(1, 2, 4, 8, requires_grad=True)
    k = torch.randn(1, 2, 4, 8)
    x = torch.randn(1, 3, 8, requires_grad=True)
    w = torch.ones(1, 8)
    s = torch.randn(1, 1, 4, 2, 8, requires_grad=True)
    dt, A = torch.rand(1, 1, 4, 2), -torch.rand(1, 2)
    B = torch.randn(1, 1, 4, 8)
    before = (flash_attention.launches, rmsnorm.launches, ssd_scan.launches)
    with pytest.raises(ValueError, match="requires_grad"):
        flash_attention.flash_attention_cuda(q, k, k)
    with pytest.raises(ValueError, match="requires_grad"):
        rmsnorm.rmsnorm_cuda(x, w)
    with pytest.raises(ValueError, match="requires_grad"):
        rmsnorm.rmsnorm_cuda(x.detach(), w.requires_grad_())
    with pytest.raises(ValueError, match="requires_grad"):
        ssd_scan.ssd_scan_cuda(s, dt, A, B, B)
    assert (flash_attention.launches, rmsnorm.launches,
            ssd_scan.launches) == before
