"""Host-side parts of kernels B1 and B2's variants, on the CPU.

The kernels run only on the card (`chip_smoke.py` holds each variant's
draws against the variant it replaced and against the plain version).
What the host decides is tested here: which variant the main path runs,
the lane variant's transposed copy of the corpus, and the
critical-path and compiler-log helpers `chip_smoke.py` reports with.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import slda_gibbs, slda_predict, slda_train
from repro_torch.kernels import sparse as sparse_mod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chip_smoke():
    """`chip_smoke.py` as a module (its import needs no card)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _chip_smoke()


@pytest.mark.parametrize("T", [1, 3, 16, 17, 40, 128, 256, 512])
@pytest.mark.parametrize("sparse", [False, True])
def test_variant_choice_over_topics_and_mode(T, sparse):
    """At T <= 16 the main path runs the new variants, for the dense and
    the sparse draw alike (a document a lane for B1, a half-warp for B2,
    two half-warp groups a warp for B3's cluster variant, B4's half-warp
    form alone); larger T the warp variants they replaced (whole-warp
    groups)."""
    small = T <= 16
    assert slda_predict.variant(T, sparse, 120) == (
        "lane" if small else "warp")
    assert slda_gibbs.variant(T) == (
        "half_warp" if small else "warp")
    _, slots = slda_train.slot_plan(300, 128, T)
    assert slots.shape[3] == (2 if small else 1)
    assert sparse_mod.draw_variant(T) == ("half_warp" if small else "warp")


def test_lane_variant_takes_documents_whose_z_fits_shared_memory():
    """Four warps' z, a byte a token, in 227 KB: N up to 1816; beside the
    sparse draw's four [17][32]-float gather stages (8.5 KB), 1748."""
    assert slda_predict.LANE_MAX_N == 1816
    assert slda_predict.variant(16, False, 1816) == "lane"
    assert slda_predict.variant(16, False, 1817) == "warp"
    assert slda_predict.LANE_MAX_N_SPARSE == 1748
    assert slda_predict.variant(16, True, 1748) == "lane"
    assert slda_predict.variant(16, True, 1749) == "warp"


def test_variants_are_numbered_as_the_launchers_take_them():
    assert slda_predict.VARIANTS == ("warp", "lane")
    assert slda_gibbs.VARIANTS == ("warp", "half_warp")
    assert set(slda_predict.variant_launches) == set(slda_predict.VARIANTS)
    assert set(slda_gibbs.variant_launches) == set(slda_gibbs.VARIANTS)


def _corpus(seed, d, n, w=50):
    rng = np.random.default_rng(seed)
    tok = torch.from_numpy(rng.integers(0, w, (d, n)).astype(np.int32))
    lens = rng.integers(0, n + 1, d)
    mask = (np.arange(n) < lens[:, None]).astype(np.float32)
    mask[rng.random((d, n)) < 0.1] = 0.0       # holes: not a prefix
    return tok, torch.from_numpy(mask)


@pytest.mark.parametrize("d,n", [(1, 5), (37, 20), (300, 120)])
def test_lane_layout_takes_each_document_once(d, n):
    """Lane d walks document d: column d of the transposed copies is that
    document's row, every document once (masks with holes kept as they
    are).  The layout is the shared corpus's, so every chain's lane d
    walks the same document."""
    tok, mask = _corpus(d, d, n)
    tok_t, mask_t = slda_predict.lane_layout(tok, mask)
    assert tok_t.dtype == torch.int32 and mask_t.dtype == torch.float32
    assert tok_t.shape == (n, d) and mask_t.shape == (n, d)
    assert tok_t.is_contiguous() and mask_t.is_contiguous()
    for i in range(d):
        assert torch.equal(tok_t[:, i], tok[i])
        assert torch.equal(mask_t[:, i], mask[i])


def test_longest_walk_and_critical_path_by_hand():
    """Real tokens [[3, 5, 0, 2], [4, 1, 6, 0]]: B1's and B2's walks are
    one document each, so the longest is 6 (chain 1, document 2); walks of
    two documents [[0, 2], [1, 3]] give 3 + 0, 5 + 2 on chain 0 and 4 + 6,
    1 + 0 on chain 1, so 10; -1 walks nothing."""
    real = torch.tensor([[3.0, 5.0, 0.0, 2.0], [4.0, 1.0, 6.0, 0.0]])
    own = SMOKE.own_walks(4)
    assert own.tolist() == [[0], [1], [2], [3]]
    assert SMOKE.longest_walk(real, own) == 6.0
    assert SMOKE.longest_walk(real[:1], own) == 5.0
    pairs = torch.tensor([[0, 2], [1, 3]])
    assert SMOKE.longest_walk(real, pairs) == 10.0
    assert SMOKE.longest_walk(real, torch.tensor([[1, -1], [2, -1]])) == 6.0
    out = SMOKE.critical_path(real, 25, [("", own, 1.5),
                                         ("replaced_", pairs, 3.0)])
    assert out == {"critical_path_steps": 150.0,
                   "ns_per_step": 1.5e6 / 150.0,
                   "replaced_critical_path_steps": 250.0,
                   "replaced_ns_per_step": 3.0e6 / 250.0}


def test_ptxas_use_reads_registers_and_spills():
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN4slda19predict_lane_kernelILb1EEEvPKi' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN4slda19predict_lane",
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 95 registers, used 0 barriers",
        "ptxas info    : Compiling entry function "
        "'_ZN4slda12other_kernelEv' for 'sm_90a'",
        "ptxas info    : Used 12 registers, used 0 barriers"])
    assert SMOKE.ptxas_use(log, ("predict_lane",)) == {
        "_ZN4slda19predict_lane_kernelILb1EEEvPKi": {
            "registers": 95, "spill_stores": 8, "spill_loads": 4}}
