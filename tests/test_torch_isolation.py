"""The port stands alone: no JAX, no reference package, no silent CPU."""
import os
import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch import serve_lm
from repro_torch.configs import SMOKES
from repro_torch.convert import corpus_from_numpy
from repro_torch.core import SLDAConfig, partition, run_nonparallel
from repro_torch.core import train_chains, predict_chains
from repro_torch.data import make_slda_corpus, train_test_split
from repro_torch.device import check_full_fp32
from repro_torch.models import init_params

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is faster, and several test
    workers on one machine do not oversubscribe its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_sources_import_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    # the multi-device half among them
    port = ROOT / "src" / "repro_torch"
    assert {port / "launch" / m for m in ("mesh.py", "sharding.py",
                                          "cost.py", "dryrun.py")} | {
        port / "configs" / "shapes.py", port / "models" / "layout.py",
        port / "serve_ensemble.py", port / "quickstart.py",
        port / "parallel_slda.py"} <= set(files)
    offenders = [str(f) for f in files if FORBIDDEN.search(f.read_text())]
    assert offenders == []


def test_cpu_run_loads_no_jax_and_no_reference_module():
    prog = textwrap.dedent("""
        import sys
        import repro_torch
        from repro_torch.core import SLDAConfig, ALGORITHMS
        from repro_torch.data import make_slda_corpus, train_test_split
        cfg = SLDAConfig(n_topics=4, vocab_size=40, n_iters=3,
                         n_pred_burnin=2, n_pred_samples=2)
        c, _ = make_slda_corpus(0, 48, 40, 4, 12, device="cpu")
        tr, te = train_test_split(c, 32)
        for name, fn in ALGORITHMS.items():
            args = (1, tr, te, cfg) + (() if name == "nonparallel" else (4,))
            y = fn(*args, device="cpu")
            assert y.shape == (16,) and bool(y.isfinite().all())
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        print("BAD", bad)
        assert not bad, bad
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", prog], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "BAD []" in out.stdout


def test_serve_lm_cpu_run_loads_no_jax_and_no_reference_module():
    """`python -m repro_torch.serve_lm --smoke --device cpu`, run in a
    process of its own for a dense arch and the SSM hybrid, generates
    and imports nothing of JAX."""
    prog = textwrap.dedent("""
        import sys
        from repro_torch import serve_lm
        for arch in ("qwen3-1.7b", "zamba2-2.7b"):    # zamba2: SSM + shared
            res = serve_lm.main(["--arch", arch, "--smoke", "--device",
                                 "cpu", "--prompt-len", "12",
                                 "--new-tokens", "3", "--combine",
                                 "weighted"])
            assert len(res["tokens"]) == 8 and len(res["tokens"][0]) == 3
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        print("BAD", bad)
        assert not bad, bad
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", prog], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "BAD []" in out.stdout


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_without_device_raise_without_cuda(no_cuda):
    cfg = SLDAConfig(n_topics=4, vocab_size=40, n_iters=2,
                     n_pred_burnin=1, n_pred_samples=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_slda_corpus(0, 16, 40, 4, 8)
    c, _ = make_slda_corpus(0, 16, 40, 4, 8, device="cpu")
    tr, te = train_test_split(c, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_nonparallel(0, tr, te, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_chains(0, partition(tr, 2), cfg)
    _, models = train_chains(0, partition(tr, 2), cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict_chains(0, models, te, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        corpus_from_numpy(c.tokens.numpy(), c.mask.numpy(), c.y.numpy())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(SMOKES["qwen3-1.7b"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_lm.main(["--smoke"])
    from repro_torch import parallel_slda, quickstart, serve_ensemble
    for example in (serve_ensemble, quickstart, parallel_slda):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            example.main([])


def test_fault_tolerance_entry_points_default_to_the_card(no_cuda,
                                                          tmp_path):
    """The supervisor, the fault plans and the health metrics run on the
    card unless asked for the CPU; asked, a supervised run with a
    checkpoint directory completes."""
    from repro_torch.core import supervised_run_average
    from repro_torch.metrics import ensemble_health, robust_z
    from repro_torch.testing import no_faults, poison, random_fault_plan
    cfg = SLDAConfig(n_topics=4, vocab_size=40, n_iters=2,
                     n_pred_burnin=1, n_pred_samples=1)
    c, _ = make_slda_corpus(0, 16, 40, 4, 8, device="cpu")
    tr, te = train_test_split(c, 8)
    for call in (lambda: supervised_run_average(0, tr, te, cfg, 2),
                 lambda: no_faults(2), lambda: poison(2, 0, 1),
                 lambda: random_fault_plan(0, 2, 3),
                 lambda: robust_z([1.0, 2.0]),
                 lambda: ensemble_health([1.0, 2.0])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    y, rep = supervised_run_average(
        0, tr, te, cfg, 2, ckpt_dir=str(tmp_path), round_iters=1,
        fault_hook=no_faults(2, device="cpu").hook(), device="cpu")
    assert y.device.type == "cpu" and rep.alive.all() and rep.rounds == 2


def test_tf32_is_refused(monkeypatch):
    check_full_fp32()
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="full float32"):
        check_full_fp32()


def test_chip_smoke_without_the_program_fails_and_prints_no_result(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)

    assert out.returncode != 0
    assert '"ok"' not in out.stdout
