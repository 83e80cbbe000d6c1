"""Kernel B2 on the card: one supervised Gibbs training sweep.

`slda_gibbs_sweep_cuda` launches `csrc/slda_gibbs.cu`, which replaces the
TPU kernel `_gibbs_kernel` of the reference (`repro/kernels/slda_gibbs.py`);
the note at the head of the source says what bounds it and what each
variant's design does about that.  `variant` picks the variant:
`half_warp` (two documents a warp, the launch-frozen logs tabulated
before the token loop; T <= 16, dense or sparse) on the main path, else
`warp` (a warp a document), the kernel the half_warp variant replaced.
The plain version is `ref.ref_slda_gibbs_sweep_chains`.  `launches`
counts the kernel's launches and nothing else, `variant_launches` the
same launches by variant; `sparse_launches` counts those of them that
drew with the sparse two-stage draw (kernel B4).
"""
from __future__ import annotations

import ctypes

import torch

from . import build, sparse as _sparse

launches = 0
sparse_launches = 0
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = ([_P] * 12 + [_I] * 5 + [_F] * 4 + [_I] + [_P] * 3 + [_I, _I]
         + [_P] * 3)
# the C launcher's numbering
VARIANTS = ("warp", "half_warp")
variant_launches = dict.fromkeys(VARIANTS, 0)
HALF_WARP_TOPICS = 16      # topics a half-warp draws at most
MAX_TOPICS = _sparse.MAX_TOPICS


def variant(T: int) -> str:
    """The variant the main path runs at T topics: `half_warp` at T <= 16,
    for the dense and the sparse draw alike, else `warp`."""
    return "half_warp" if T <= HALF_WARP_TOPICS else "warp"


def slda_gibbs_sweep_cuda(tokens, mask, uniforms, z, ndt, y, inv_len, ntw_t,
                          nt, eta, *, alpha, beta, rho, supervised=True,
                          topic_index=None, kernel_variant=None):
    """tokens int32 / mask, uniforms f32 / z int32 [M, D, N]; ndt f32
    [M, D, T]; y, inv_len f32 [M, D]; ntw_t f32 [M, W, T]; nt, eta f32
    [M, T]; topic_index None (the dense draw) or the sparse draw's
    (idx, vmask, occm) of ntw_t.  `kernel_variant` None (`variant`'s
    choice, the main path) or a name of VARIANTS, which `chip_smoke.py`
    passes to time the replaced kernel on the same inputs.  Returns
    (z_new [M, D, N], ndt_new [M, D, T]), on the current stream."""
    global launches, sparse_launches
    M, D, N = tokens.shape
    W, T = ntw_t.shape[-2:]
    dev = tokens.device
    for name, t, dtype, shape in (
            ("tokens", tokens, torch.int32, (M, D, N)),
            ("mask", mask, torch.float32, (M, D, N)),
            ("uniforms", uniforms, torch.float32, (M, D, N)),
            ("z", z, torch.int32, (M, D, N)),
            ("ndt", ndt, torch.float32, (M, D, T)),
            ("y", y, torch.float32, (M, D)),
            ("inv_len", inv_len, torch.float32, (M, D)),
            ("ntw_t", ntw_t, torch.float32, (M, W, T)),
            ("nt", nt, torch.float32, (M, T)),
            ("eta", eta, torch.float32, (M, T))):
        build.check_operand(name, t, dtype, shape, dev)
    if not 1 <= T <= MAX_TOPICS:
        raise ValueError(f"the training kernel takes 1 <= T <= "
                         f"{MAX_TOPICS}, got {T}")
    index = build.topic_index_operands(topic_index, M, W, T, dev)
    sparse = topic_index is not None
    kind = kernel_variant or variant(T)
    if kind not in VARIANTS:
        raise ValueError(f"slda_gibbs: no {kind} variant")
    if kind == "half_warp" and variant(T) != "half_warp":
        raise ValueError(f"slda_gibbs: the half_warp variant draws at "
                         f"T <= {HALF_WARP_TOPICS}")
    z_out = torch.empty_like(z)
    ndt_out = torch.empty_like(ndt)
    if M * D == 0:
        return z_out, ndt_out
    launch = build.bind("slda_gibbs", "slda_gibbs_sweep_launch", _ARGS)
    # the half_warp variant's logs of the table, [M, W, 2T]
    logs = torch.empty((M, W, 2 * T), dtype=torch.float32, device=dev) \
        if kind == "half_warp" else None
    rec = _sparse.record_scratch(topic_index, M, W, T, dev)
    with build.on_device(dev):
        rc = launch(*(t.data_ptr() for t in (
            tokens, mask, uniforms, z, ndt, y, inv_len, ntw_t, nt, eta,
            z_out, ndt_out)), M, D, N, T, W, float(alpha), float(beta),
            float(W * beta), float(rho), int(supervised), *index,
            VARIANTS.index(kind), 0 if logs is None else logs.data_ptr(),
            0 if rec is None else rec.data_ptr(), build.stream_of(dev))
    build.check_launch("slda_gibbs", rc)
    launches += 1
    variant_launches[kind] += 1
    sparse_launches += sparse
    return z_out, ndt_out
