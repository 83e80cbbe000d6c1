"""Kernel B4's packed topic index, on the CPU.

The sampler kernels read a word's index (idx, vmask [cap], occm [T]) as
one packed record (`sparse.pack_topic_index`) and draw by selects on its
bits.  Here: the record round-trips to the rows it was packed from, and
every CUDA wrapper takes T = 512 and refuses T = 513 before it counts a
launch.  The loop model of the lane / half-warp draw on the record,
against the reference's draw, is in `tests/test_torch_sparse.py`.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import types
from repro_torch.kernels import slda_gibbs, slda_predict, slda_train, sparse
from repro_torch.kernels.sparse import (pack_topic_index, record_layout,
                                        unpack_topic_index)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _index(rng, r, t, cap, fresh=False):
    """An index of r rows: a count table's own (`fresh`), else distinct
    random topics with random valid slots and their membership mask."""
    if fresh:
        counts = (rng.integers(0, 4, (r, t))
                  * (rng.random((r, t)) < 0.3)).astype(np.float32)
        return types.topic_occupancy_index(torch.from_numpy(counts), cap)
    idx = np.argsort(rng.random((r, t)), axis=-1)[:, :cap].astype(np.int32)
    vmask = (rng.random((r, cap)) < 0.7).astype(np.float32)
    occm = np.zeros((r, t), np.float32)
    np.put_along_axis(occm, idx, vmask, axis=-1)
    return tuple(map(torch.from_numpy, (idx, vmask, occm)))


# ------------------------------------------------------------ the record

@pytest.mark.parametrize("t", [1, 3, 16, 17, 128, 512])
def test_record_round_trips_to_the_index_rows(t):
    """pack then unpack gives back (idx, vmask, occm) exactly, for fresh
    and random indexes at every cap kind (1, a few, 32, T); a record is a
    multiple of 16 bytes, and 16 bytes at T <= 16."""
    rng = np.random.default_rng(t)
    for cap in sorted({1, min(3, t), min(32, t), t}):
        ib, ow, vw, rw = record_layout(t, cap)
        assert ib == (4 if t <= 16 else 8 if t <= 256 else 16)
        assert rw % 4 == 0 and rw >= ow + vw + -(-cap * ib // 32)
        if t <= 16:
            assert rw == 4
        for fresh in (False, True):
            idx, vm, om = _index(rng, 50, t, cap, fresh)
            rec = pack_topic_index(idx, vm, om)
            assert rec.dtype == torch.int32 and rec.shape == (50, rw)
            back = unpack_topic_index(rec, t, cap)
            for got, want in zip(back, (idx, vm, om)):
                assert got.dtype == want.dtype
                assert torch.equal(got, want)


def test_record_of_a_chain_index_packs_each_word():
    """[M, W, ·] rows pack to [M, W, rw], row by row."""
    rng = np.random.default_rng(5)
    counts = torch.from_numpy(
        (rng.integers(0, 3, (2, 30, 40)) * (rng.random((2, 30, 40)) < 0.2))
        .astype(np.float32))
    idx, vm, om = types.topic_occupancy_index(counts, 8)
    rec = pack_topic_index(idx, vm, om)
    assert rec.shape == (2, 30, record_layout(40, 8)[3])
    flat = pack_topic_index(idx.reshape(60, 8), vm.reshape(60, 8),
                            om.reshape(60, 40))
    assert torch.equal(rec.reshape(60, -1), flat)


def test_record_bits_where_the_index_is_not_zero():
    """A flag is set where vmask / occm is not 0: the index builder makes
    them exactly 0 or 1, which the kernels' selects rely on."""
    idx = torch.tensor([[2, 0, 1]], dtype=torch.int32)
    vm = torch.tensor([[1.0, 0.0, 1.0]])
    om = torch.tensor([[0.0, 1.0, 1.0, 0.0]])
    rec = pack_topic_index(idx, vm, om)
    assert rec.tolist() == [[0b0110, 0b101, 2 | 0 << 4 | 1 << 8, 0]]


# --------------------------------------------------- T = 512 at the wrappers

def _sampler_args(t, rng):
    """B1, B2 and B3 operands at T topics (M = 1, D = 3, N = 4, W = 5)."""
    M, D, N, W = 1, 3, 4, 5
    f = lambda *s: torch.from_numpy(rng.random(s, dtype=np.float32))
    i = lambda hi, *s: torch.from_numpy(
        rng.integers(0, hi, s).astype(np.int32))
    tok, mask, z = i(W, M, D, N), torch.ones(M, D, N), i(t, M, D, N)
    ndt, ntw_t = f(M, D, t), f(M, W, t)
    y, il, nt, eta = f(M, D), f(M, D), f(M, t), f(M, t)
    predict = (tok[0], mask[0], i(99, M, D), z, ndt, ntw_t)
    gibbs = (tok, mask, f(M, D, N), z, ndt, y, il, ntw_t, nt, eta)
    train = (tok, mask, i(99, M, D), z, ndt, y, il, ntw_t, nt, eta)
    index = tuple(a.contiguous() for a in
                  types.topic_occupancy_index(ntw_t, 32))
    return predict, gibbs, train, index


@pytest.mark.parametrize("t,ok", [(512, True), (513, False)])
@pytest.mark.parametrize("sparse_draw", [False, True])
def test_cuda_wrappers_take_512_topics_and_refuse_513(t, ok, sparse_draw):
    """T = 512 passes every wrapper's checks and gets to the build (no
    card here: a RuntimeError); T = 513 is refused with a ValueError
    before it.  Neither counts a launch."""
    rng = np.random.default_rng(t)
    predict, gibbs, train, index = _sampler_args(t, rng)
    ti = index if sparse_draw else None
    mods = (slda_predict, slda_gibbs, slda_train)
    before = [(m.launches, m.sparse_launches, dict(m.variant_launches))
              for m in mods]
    calls = [
        lambda: slda_predict.slda_predict_sweeps_cuda(
            *predict, alpha=0.1, n_burnin=1, n_samples=1, topic_index=ti),
        lambda: slda_gibbs.slda_gibbs_sweep_cuda(
            *gibbs, alpha=0.1, beta=0.01, rho=0.5, topic_index=ti),
        lambda: slda_train.slda_train_sweeps_cuda(
            *train, alpha=0.1, beta=0.01, rho=0.5, n_sweeps=2, doc_block=2,
            topic_index=ti)]
    r = 6
    p = torch.rand((r, t))
    rows = tuple(a[0, :r].contiguous() if a.shape[1] >= r else
                 a[0, :1].expand(r, -1).contiguous() for a in index)
    calls.append(lambda: sparse.sparse_two_stage_draw_cuda(
        p, torch.rand(r), *rows))
    calls.append(lambda: sparse.pack_topic_index_cuda(*rows))
    for call in calls:
        if ok and torch.cuda.is_available():
            continue                       # a card would launch: not here
        with pytest.raises(RuntimeError if ok else ValueError,
                           match="CUDA" if ok else "T"):
            call()
    assert [(m.launches, m.sparse_launches, dict(m.variant_launches))
            for m in mods] == before


def test_draw_alone_variants_and_their_topics():
    """B4 alone runs the form most sparse launches run at T topics
    (`half_warp` up to 16, else `warp`); `lane` and `half_warp` are
    refused above 16 topics before any build."""
    assert sparse.VARIANTS == ("warp", "lane", "half_warp")
    assert [sparse.draw_variant(t) for t in (1, 16, 17, 512)] == [
        "half_warp", "half_warp", "warp", "warp"]
    r, t = 4, 17
    idx, vm, om = types.topic_occupancy_index(torch.rand((r, t)), 3)
    for kind in ("lane", "half_warp"):
        with pytest.raises(ValueError, match=f"the {kind} variant draws"):
            sparse.sparse_two_stage_draw_cuda(
                torch.rand((r, t)), torch.rand(r), idx, vm, om,
                kernel_variant=kind)
    with pytest.raises(ValueError, match="no block variant"):
        sparse.sparse_two_stage_draw_cuda(torch.rand((r, t)), torch.rand(r),
                                          idx, vm, om, kernel_variant="block")
