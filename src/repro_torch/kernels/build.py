"""Builds the CUDA kernels at first use and binds them with ctypes.

Each source under `csrc/` is compiled by its own `nvcc` (all started
together) into a shared library with a plain C interface, under
`build/repro_torch_kernels/<hash of the sources and flags>/` at the root
of the checkout.  A finished build is reused; a changed source builds
anew.  A failed build raises: there is no fallback to the plain versions.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from repro_torch.device import check_full_fp32

SOURCES = ("slda_predict.cu", "slda_gibbs.cu", "slda_train.cu",
           "flash_attention.cu", "ssd_scan.cu", "rmsnorm.cu")
FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
         # no FMA contraction: each expression rounds as the plain
         # version's separate tensor operations do; no fast math either
         "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"

_libs: dict = {}
_bound: dict = {}         # (stem, launcher) -> the bound ctypes function
_SAME_DEVICE = contextlib.nullcontext()
build_info: dict = {}     # directory, seconds, compiler log of this process


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _compile(out: Path) -> str:
    """Compile every source into `out`, one nvcc per source in parallel."""
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    tmp.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = [(src, subprocess.Popen(
        [nvcc, *FLAGS, "-o", str(tmp / f"lib{Path(src).stem}.so"),
         str(CSRC / src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)) for src in SOURCES]
    logs, failed = [], []
    for src, p in procs:
        text = p.communicate()[0]
        logs.append(f"== nvcc {src} (rc={p.returncode})\n{text}")
        if p.returncode:
            failed.append(src)
    log = "\n".join(logs)
    (tmp / "build.log").write_text(log)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
    try:
        tmp.rename(out)
    except OSError:          # another process finished the same build first
        shutil.rmtree(tmp, ignore_errors=True)
    return log


def load(stem: str) -> ctypes.CDLL:
    """The shared library built from `csrc/<stem>.cu`, building all
    sources first if this checkout has no build of them yet."""
    if not _libs:
        if not torch.cuda.is_available():
            raise RuntimeError("the CUDA kernels need a CUDA device")
        check_full_fp32()
        t0 = time.perf_counter()
        out = BUILD_ROOT / _digest()
        if all((out / f"lib{Path(s).stem}.so").exists() for s in SOURCES):
            log = (out / "build.log").read_text()
        else:
            log = _compile(out)
        for src in SOURCES:
            s = Path(src).stem
            _libs[s] = ctypes.CDLL(str(out / f"lib{s}.so"))
        build_info.update(directory=str(out), log=log,
                          seconds=time.perf_counter() - t0)
    return _libs[stem]


def bind(stem: str, name: str, argtypes):
    """A C launcher of library `stem` with its argument types set, bound
    once and cached; every launcher returns cudaGetLastError() as an
    int."""
    fn = _bound.get((stem, name))
    if fn is None:
        fn = getattr(load(stem), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _bound[stem, name] = fn
    return fn


def check_launch(stem: str, rc: int) -> None:
    """Raise if a launcher reported a CUDA error."""
    if rc:
        err = load(stem).slda_cuda_error_string
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"CUDA launch failed ({rc}): "
                           f"{err(rc).decode()}")


def check_operand(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    """Validate a kernel operand before its pointer is handed over.  An
    operand that requires a gradient is refused: the kernels have no
    backward, so an autograd graph through one would lose its gradient
    without a word (training takes the plain route)."""
    if t.requires_grad:
        raise ValueError(f"{name}: requires_grad, and the CUDA kernels "
                         "have no backward: run the plain route "
                         "(use_kernels=False)")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def topic_index_operands(topic_index, M: int, W: int, T: int,
                         device) -> tuple:
    """The sparse draw's operands `(idx, vmask, occm, cap)` as a launcher
    takes them: null pointers and cap 0 for the dense draw (None), else
    the checked pointers of idx int32 / vmask f32 [M, W, cap] and occm f32
    [M, W, T] with 1 <= cap <= T."""
    if topic_index is None:
        return 0, 0, 0, 0
    idx, vmask, occm = topic_index
    cap = idx.shape[-1]
    if not 1 <= cap <= T:
        raise ValueError(f"topic index: cap {cap} outside 1..T={T}")
    for name, t, dtype, shape in (
            ("idx", idx, torch.int32, (M, W, cap)),
            ("vmask", vmask, torch.float32, (M, W, cap)),
            ("occm", occm, torch.float32, (M, W, T))):
        check_operand(name, t, dtype, shape, device)
    return idx.data_ptr(), vmask.data_ptr(), occm.data_ptr(), cap


def on_device(device):
    """A context in which `device` is the current CUDA device (the
    launchers raise the current device's limits): `torch.cuda.device`,
    or no context where it is current already."""
    if device.index is None or device.index == torch.cuda.current_device():
        return _SAME_DEVICE
    return torch.cuda.device(device)


def stream_of(device) -> int:
    """The current PyTorch stream of `device`, as the launchers take it
    (the raw handle, without building a `torch.cuda.Stream` a call)."""
    index = torch.cuda.current_device() if device.index is None else \
        device.index
    return torch._C._cuda_getCurrentRawStream(index)
