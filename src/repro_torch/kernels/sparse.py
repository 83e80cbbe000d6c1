"""The sparse two-stage categorical draw (kernel B4's plain version).

`sparse_two_stage_draw` replaces only the draw of the three samplers: the
exact dense weights p are formed as before, then split by the word's
occupancy index into

  * a sparse bucket `sv = take_along(p, idx) · vmask` over the word's
    top-`cap` topics, drawn through the prefix sum `sv @ triu(cap)`;
  * a residual `rv = p · (1 − occm)` holding what the index missed,
    drawn hierarchically: `nb = ⌈T/blk⌉` blocks of `blk = min(16, T)`
    topics, the block by the prefix sum of the block totals, then the
    topic by the prefix sum inside the block.

`scatter(sv) + rv == p` holds exactly in float32 for any index content,
so a stale index changes which bucket serves a topic, never the
distribution.  With the identity index (`idx = arange(T)`, `cap = T`,
`vmask = occm = 1`) the residual is exactly zero and the draw is bit for
bit the dense draw.  The operation order is the reference's
(`repro.kernels.sparse`); the CUDA kernels run the same three prefix
sums left to right (`csrc/slda_common.cuh`, `draw_topic_sparse`), and
`sparse_two_stage_draw_cuda` runs that device function alone on the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.mathutil import upper_tri_ones
from . import build

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 6 + [_I] * 3 + [_P]


def residual_blocks(n_topics: int) -> tuple[int, int]:
    """(block width blk, block count nb) of the hierarchical residual."""
    blk = min(16, n_topics)
    return blk, -(-n_topics // blk)


def _count_below(c, x, top):
    """min(#{j : c_j < x}, top) along the last axis."""
    return (c < x[..., None]).sum(-1).clamp(max=top)


def sparse_two_stage_draw(p, u, idx, vmask, occm):
    """z ~ Categorical(p) through the two-stage decomposition.

    p [..., T] the exact dense weights; u [...] one uniform per row (the
    dense draw's budget); idx int32 / vmask f32 [..., cap] the rows of the
    word's index; occm f32 [..., T] its membership mask.  Returns int32
    z in [0, T)."""
    return two_stage_draw(p, u, idx, vmask, occm)[0]


def two_stage_draw(p, u, idx, vmask, occm):
    """`sparse_two_stage_draw`, also returning which rows took stage 2
    (bool, the residual).  Stage 2 is computed for every row and selected
    where the target lies past the sparse bucket, which is bit for bit
    the reference's predicated form."""
    t_dim, cap = p.shape[-1], idx.shape[-1]
    blk, nb = residual_blocks(t_dim)
    dev = p.device
    idx_l = idx.long()

    sv = p.gather(-1, idx_l) * vmask
    rv = p * (1.0 - occm)
    cs = sv @ upper_tri_ones(cap, dev)
    q_s = cs[..., -1]

    pad = nb * blk - t_dim
    if pad:
        rv = torch.nn.functional.pad(rv, (0, pad))
    rblk = rv.reshape(rv.shape[:-1] + (nb, blk))
    # block totals from the same contraction as the fine prefix, so the
    # block pick never overshoots its fine prefix
    cfine = rblk @ upper_tri_ones(blk, dev)             # [..., nb, blk]
    rsum = cfine[..., -1]
    cr = rsum @ upper_tri_ones(nb, dev)                 # [..., nb]
    q_r = cr[..., -1]

    tgt = u * (q_s + q_r)
    # q_r == 0: the fully indexed case, where u·q_s may round up to q_s
    in_s = (tgt < q_s) | (q_r <= 0.0)
    k_s = _count_below(cs, tgt, cap - 1)
    z_s = idx_l.gather(-1, k_s[..., None])[..., 0]

    tr = tgt - q_s
    jb = _count_below(cr, tr, nb - 1)
    cr0 = torch.cat([torch.zeros_like(cr[..., :1]), cr], dim=-1)
    rem = tr - cr0.gather(-1, jb[..., None])[..., 0]
    cf = cfine.gather(-2, jb[..., None, None].expand(
        jb.shape + (1, blk)))[..., 0, :]
    k_f = _count_below(cf, rem, blk - 1)
    z_r = (jb * blk + k_f).clamp(max=t_dim - 1)
    return torch.where(in_s, z_s, z_r).to(torch.int32), ~in_s


def sparse_two_stage_draw_cuda(p, u, idx, vmask, occm):
    """The CUDA kernels' device function `draw_topic_sparse` alone, one
    warp per row: p f32 [R, T], u f32 [R], idx int32 / vmask f32
    [R, cap], occm f32 [R, T], on the card.  Returns int32 z [R], on the
    current stream.  It is the check and the time of the draw by itself;
    the sampler kernels run it inside their token loop."""
    R, T = p.shape
    cap = idx.shape[-1]
    if not 1 <= cap <= T <= 256:
        raise ValueError(f"the sparse draw takes 1 <= cap <= T <= 256, "
                         f"got cap={cap}, T={T}")
    dev = p.device
    for name, t, dtype, shape in (
            ("p", p, torch.float32, (R, T)), ("u", u, torch.float32, (R,)),
            ("idx", idx, torch.int32, (R, cap)),
            ("vmask", vmask, torch.float32, (R, cap)),
            ("occm", occm, torch.float32, (R, T))):
        build.check_operand(name, t, dtype, shape, dev)
    z = torch.empty(R, dtype=torch.int32, device=dev)
    if R == 0:
        return z
    launch = build.bind("slda_predict", "slda_sparse_draw_launch", _ARGS)
    with build.on_device(dev):
        rc = launch(*(t.data_ptr() for t in (p, u, idx, vmask, occm, z)),
                    R, T, cap, build.stream_of(dev))
    build.check_launch("slda_predict", rc)
    return z


def build_topic_index(table_t, cap: int):
    """The index `(idx, vmask, occm)` of a word-major `[..., W, T]` table
    (`core.types.topic_occupancy_index`, imported at call time so that
    the kernels package does not import the core package)."""
    from repro_torch.core.types import topic_occupancy_index
    return topic_occupancy_index(table_t, cap)


def gather_index_rows(w, idx, vmask, occm):
    """The index rows of the words `w` [...]: each `[W, ·]` table becomes
    `[..., ·]` rows aligned with `w`, the row gather of the samplers'
    table."""
    return idx[w], vmask[w], occm[w]
