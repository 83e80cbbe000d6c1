"""The port's AdamW (`optim.adamw`) and synthetic LM stream (`data.lm`)
against the reference's.

The same numpy-made trees go to both packages.  Tolerances: one
`adamw_update` 1e-6 (numpy's allclose, atol = rtol: float32 update math
in both, summation order aside) in parameters, moments and the
per-chain gradient norm, with float32 and bfloat16 optimizer state (the
bf16 moments compared after the same rounding); `lr_schedule` 1e-7
relative; the token stream bit for bit.  `quantize_grads` draws its
noise from torch generators, not JAX's, so it is held to the
reference's statistical test (`tests/test_optim.py`): error at most one
quantization step, mean error under a tenth of one.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.data import lm_batch_iterator as jlm_batch_iterator
from repro.data import synthetic_lm_batch as jsynthetic_lm_batch
from repro.optim import adamw as jadamw
from repro_torch.data import lm_batch_iterator, synthetic_lm_batch
from repro_torch.optim import (OptConfig, adamw_update,
                               clip_by_global_norm_per_chain,
                               global_norm_per_chain, init_opt_state,
                               lr_schedule, quantize_grads)

TOL = 1e-6
CHAINS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed, scale=1.0):
    """A parameter-shaped tree as numpy: a list of layers, a matrix, a
    vector and a stacked leaf [L, C, ...] (chain axis 1)."""
    rng = np.random.default_rng(seed)

    def a(*shape):
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    return {"embed": {"table": a(CHAINS, 12, 8)},
            "layers": [{"w": a(CHAINS, 8, 8), "b": a(CHAINS, 8)}
                       for _ in range(2)],
            "layers_stacked": {"w": a(2, CHAINS, 8, 4)}}


def _to_torch(tree, dtype=torch.float32):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)).to(dtype),
                        tree)


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


def _assert_trees(got, want, tol=TOL):
    g, w = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(_np(a), _np(b), atol=tol, rtol=tol)


@pytest.mark.parametrize("opt_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_the_reference(opt_dtype):
    """Two steps (the second from nonzero moments), chain 1's gradients
    scaled to be clipped."""
    cfg = OptConfig(lr=1e-2, warmup_steps=1, total_steps=20,
                    clip_norm=1.0, opt_dtype=opt_dtype)
    jcfg = jadamw.OptConfig(**cfg.__dict__)
    params = _tree(0)
    jp, tp = _to_jax(params), _to_torch(params)
    js = jadamw.init_opt_state(jp, jcfg)
    ts = init_opt_state(tp, cfg)
    assert ts["m"]["embed"]["table"].dtype == (
        torch.bfloat16 if opt_dtype == "bfloat16" else torch.float32)
    for step in range(2):
        grads = _tree(10 + step, scale=0.1)
        grads["layers"][0]["w"][1] *= 100.0
        jp, js, jm = jadamw.adamw_update(jp, _to_jax(grads), js, jcfg)
        tp, ts, tm = adamw_update(tp, _to_torch(grads), ts, cfg)
        _assert_trees(tp, jp)
        for k in ("m", "v"):
            _assert_trees(ts[k], jax.tree.map(
                lambda x: np.asarray(x).astype(np.float32), js[k]))
        assert int(ts["step"]) == int(js["step"]) == step + 1
        np.testing.assert_allclose(tm["grad_norm"].numpy(),
                                   np.asarray(jm["grad_norm"]), rtol=TOL)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-7)
    assert float(tm["grad_norm"][1]) > 1.0        # chain 1 was clipped


def test_lr_schedule_matches_the_reference():
    cfg = OptConfig(lr=3e-4, warmup_steps=10, total_steps=100,
                    min_lr_frac=0.1)
    jcfg = jadamw.OptConfig(**cfg.__dict__)
    for step in (0, 1, 5, 10, 11, 55, 99, 100, 150):
        got = float(lr_schedule(cfg, step))
        want = float(jadamw.lr_schedule(jcfg, step))
        assert got == pytest.approx(want, rel=1e-7, abs=0.0), step
    assert float(lr_schedule(cfg, 0)) == 0.0
    assert float(lr_schedule(cfg, 10)) == pytest.approx(3e-4, rel=1e-6)
    assert float(lr_schedule(cfg, 100)) == pytest.approx(3e-5, rel=1e-6)
    assert float(lr_schedule(cfg, torch.tensor(55, dtype=torch.int32))) \
        == pytest.approx(float(jadamw.lr_schedule(jcfg, 55)), rel=1e-7)


def test_clipping_is_independent_per_chain():
    """Only chain 1's gradients explode: every chain's norm after
    clipping is at most 1, chains 0 and 2 are untouched, and the norms
    before clipping are the reference's."""
    grads = jax.tree.map(lambda x: np.ones_like(x), _tree(0))
    grads["layers"][1]["b"][1] *= 1e6
    grads["layers_stacked"]["w"][:, 1] *= 1e6
    t = _to_torch(grads)
    clipped, norms = clip_by_global_norm_per_chain(t, 1.0)
    _, jnorms = jadamw.clip_by_global_norm_per_chain(_to_jax(grads), 1.0)
    np.testing.assert_allclose(norms.numpy(), np.asarray(jnorms), rtol=TOL)
    after = global_norm_per_chain(clipped)
    assert (after <= 1.0 + 1e-4).all() and float(norms[1]) > 1e5
    assert torch.equal(clipped["layers"][0]["w"][0],
                       t["layers"][0]["w"][0] * float(
                           min(1.0, 1.0 / (float(norms[0]) + 1e-9))))
    assert torch.equal(clipped["layers_stacked"]["w"][:, 2],
                       t["layers_stacked"]["w"][:, 2] * float(
                           min(1.0, 1.0 / (float(norms[2]) + 1e-9))))


def test_chain_updates_do_not_mix():
    """Zero gradients for chain 0 leave its parameters where weight decay
    alone (0 here) puts them; chain 1 moves."""
    cfg = OptConfig(lr=1e-2, weight_decay=0.0, warmup_steps=0)
    tp = _to_torch(_tree(1))
    before = jax.tree.map(lambda x: x.clone(), tp)
    grads = jax.tree.map(torch.zeros_like, tp)
    grads["layers"][0]["w"][1] = 1.0
    grads["embed"]["table"][1] = 1.0
    tp, _, _ = adamw_update(tp, grads, init_opt_state(tp, cfg), cfg)
    assert torch.equal(tp["layers"][0]["w"][0], before["layers"][0]["w"][0])
    assert torch.equal(tp["embed"]["table"][0], before["embed"]["table"][0])
    assert float((tp["layers"][0]["w"][1]
                  - before["layers"][0]["w"][1]).abs().max()) > 1e-4


def test_quantize_grads_unbiased_bounded_and_stable():
    g = {"w": torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, 64)).astype(np.float32)), "b": [torch.ones(5)]}
    qs = [quantize_grads(g, seed)["w"] for seed in range(16)]
    err = torch.stack([q - g["w"] for q in qs])
    scale = float(g["w"].abs().max()) / 127
    assert float(err.abs().max()) <= scale + 1e-6
    assert abs(float(err.mean())) < scale * 0.1
    # one seed, one answer in any process; another seed, another draw
    assert torch.equal(quantize_grads(g, 3)["w"], quantize_grads(g, 3)["w"])
    assert not torch.equal(qs[0], qs[1])
    assert torch.equal(quantize_grads(g, 3)["b"][0], g["b"][0])


def test_synthetic_lm_batch_is_the_references_bit_for_bit():
    for seed, step in ((0, 0), (7919, 3), (2 ** 31 + 5, 12)):
        got = synthetic_lm_batch(seed, step, 4, 33, 92544)
        want = jsynthetic_lm_batch(seed, step, 4, 33, 92544)
        for k in ("tokens", "targets"):
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
        assert torch.equal(got["tokens"][:, 1:], got["targets"][:, :-1])
    it, jit_ = lm_batch_iterator(1, 2, 8, 100, start_step=5), \
        jlm_batch_iterator(1, 2, 8, 100, start_step=5)
    for _ in range(3):
        (s, b), (js, jb) = next(it), next(jit_)
        assert s == js
        np.testing.assert_array_equal(b["tokens"].numpy(),
                                      np.asarray(jb["tokens"]))


def test_bf16_state_is_the_references_rounding():
    """bf16 moments round as ml_dtypes' bfloat16 does (round to nearest
    even), so the port's state equals the reference's bit for bit where
    their float32 moments agree."""
    x = np.float32([1.0 + 2 ** -8, 1.0 + 3 * 2 ** -9, -3.14159, 1e-20])
    got = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    want = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    np.testing.assert_array_equal(got, want)
