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
sums left to right (`csrc/slda_common.cuh`: `draw_topic_sparse` in the
warp layout, `draw_topic_sparse_lane` and `draw_topic_sparse_half` where
a lane or a half-warp draws a document at T <= 16), reading the index as
one packed record a word (`pack_topic_index`), and
`sparse_two_stage_draw_cuda` runs each form alone on the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.mathutil import upper_tri_ones
from . import build

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 7 + [_I] * 4 + [_P]
_PACK_ARGS = [_P] * 4 + [_I] * 3 + [_P]
MAX_TOPICS = 512
# the standalone launcher's numbering; lane and half_warp at T <= 16
VARIANTS = ("warp", "lane", "half_warp")
LANE_TOPICS = 16


def draw_variant(T: int) -> str:
    """The form of the draw most of the samplers' sparse launches run at T
    topics: up to 16 topics `half_warp` (B2's and B3's; B1's one launch a
    prediction runs `lane`, the same bits), else `warp`."""
    return "half_warp" if T <= LANE_TOPICS else "warp"


def record_layout(n_topics: int, cap: int) -> tuple[int, int, int, int]:
    """The packed record of a word's index at T topics and cap slots, in
    32-bit words: (ib, ow, vw, rw) with ib the bits of a topic number (4 at
    T <= 16, 8 at T <= 256, else 16), occm in words [0, ow), vmask in
    [ow, ow + vw), the topic numbers from ow + vw, and rw the words of a
    record (a multiple of 4: 16 bytes at T <= 16).  `csrc/slda_common.cuh`
    (`rec_words`) computes the same."""
    ib = 4 if n_topics <= 16 else 8 if n_topics <= 256 else 16
    ow, vw = -(-n_topics // 32), -(-cap // 32)
    iw = -(-(cap * ib) // 32)
    return ib, ow, vw, (ow + vw + iw + 3) // 4 * 4


def _flag_words(flags, n_words):
    """bool [..., L] as int64 32-bit words [..., n_words], flag l at bit
    l % 32 of word l // 32."""
    pad = n_words * 32 - flags.shape[-1]
    f = torch.nn.functional.pad(flags.long(), (0, pad))
    f = f.reshape(f.shape[:-1] + (n_words, 32))
    return (f << torch.arange(32, device=f.device)).sum(-1)


def pack_topic_index(idx, vmask, occm):
    """The kernels' packed record of each row of an index: idx int32 /
    vmask f32 [..., cap] and occm f32 [..., T] → int32 [..., rw]
    (`record_layout`).  A flag is set where vmask or occm is not 0:
    `topic_occupancy_index` makes both exactly 0 or 1, so the kernels'
    selects on these bits draw what the plain version's products draw.
    It is the plain version of the packing each sparse launch runs on the
    card first (`pack_topic_index_cuda`)."""
    t_dim, cap = occm.shape[-1], idx.shape[-1]
    ib, ow, vw, rw = record_layout(t_dim, cap)
    per = 32 // ib
    iw = -(-cap // per)
    ix = torch.nn.functional.pad(idx.long() & ((1 << ib) - 1),
                                 (0, iw * per - cap))
    ix = ix.reshape(ix.shape[:-1] + (iw, per))
    ix = (ix << (ib * torch.arange(per, device=ix.device))).sum(-1)
    words = torch.cat([_flag_words(occm != 0, ow), _flag_words(vmask != 0, vw),
                       ix], -1)
    words = torch.nn.functional.pad(words, (0, rw - words.shape[-1]))
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def unpack_topic_index(rec, n_topics: int, cap: int):
    """`pack_topic_index` read back: rec int32 [..., rw] → (idx int32,
    vmask f32 [..., cap], occm f32 [..., T])."""
    ib, ow, vw, rw = record_layout(n_topics, cap)
    if rec.shape[-1] != rw:
        raise ValueError(f"record of {rec.shape[-1]} words, expected {rw}")
    w = rec.long() & 0xFFFFFFFF

    def field(words, width, count):
        per = 32 // width
        v = (words[..., None] >> (width * torch.arange(per, device=w.device))
             ) & ((1 << width) - 1)
        return v.reshape(v.shape[:-2] + (-1,))[..., :count]
    occm = field(w[..., :ow], 1, n_topics).float()
    vmask = field(w[..., ow:ow + vw], 1, cap).float()
    idx = field(w[..., ow + vw:], ib, cap).to(torch.int32)
    return idx, vmask, occm


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


def _check_index(idx, vmask, occm, rows, T, dev):
    cap = idx.shape[-1]
    if not 1 <= cap <= T <= MAX_TOPICS:
        raise ValueError(f"the sparse draw takes 1 <= cap <= T <= "
                         f"{MAX_TOPICS}, got cap={cap}, T={T}")
    for name, t, dtype, shape in (
            ("idx", idx, torch.int32, (rows, cap)),
            ("vmask", vmask, torch.float32, (rows, cap)),
            ("occm", occm, torch.float32, (rows, T))):
        build.check_operand(name, t, dtype, shape, dev)
    return cap


def sparse_two_stage_draw_cuda(p, u, idx, vmask, occm, *,
                               kernel_variant=None):
    """Kernel B4 alone on the card: p f32 [R, T], u f32 [R], idx int32 /
    vmask f32 [R, cap], occm f32 [R, T].  The launch packs the index rows
    into records, then draws a row a lane (`lane`), a half-warp
    (`half_warp`; both at T <= 16) or a warp (`warp`), the forms the
    sampler kernels run inside their token loop; `kernel_variant` None is
    `draw_variant(T)`.  Returns int32 z [R], on the current stream.  It is
    the check and the time of the draw by itself."""
    R, T = p.shape
    dev = p.device
    cap = _check_index(idx, vmask, occm, R, T, dev)
    for name, t, dtype, shape in (
            ("p", p, torch.float32, (R, T)), ("u", u, torch.float32, (R,))):
        build.check_operand(name, t, dtype, shape, dev)
    kind = kernel_variant or draw_variant(T)
    if kind not in VARIANTS:
        raise ValueError(f"sparse draw: no {kind} variant")
    if kind != "warp" and T > LANE_TOPICS:
        raise ValueError(f"sparse draw: the {kind} variant draws at "
                         f"T <= {LANE_TOPICS}")
    z = torch.empty(R, dtype=torch.int32, device=dev)
    if R == 0:
        return z
    rec = torch.empty((R, record_layout(T, cap)[3]), dtype=torch.int32,
                      device=dev)
    launch = build.bind("slda_predict", "slda_sparse_draw_launch", _ARGS)
    with build.on_device(dev):
        rc = launch(*(t.data_ptr() for t in (p, u, idx, vmask, occm, rec, z)),
                    R, T, cap, VARIANTS.index(kind), build.stream_of(dev))
    build.check_launch("slda_predict", rc)
    return z


def pack_topic_index_cuda(idx, vmask, occm):
    """The sparse launches' first kernel alone: `pack_topic_index` of
    idx int32 / vmask f32 [R, cap] and occm f32 [R, T] on the card."""
    R, T = occm.shape
    dev = occm.device
    cap = _check_index(idx, vmask, occm, R, T, dev)
    rec = torch.empty((R, record_layout(T, cap)[3]), dtype=torch.int32,
                      device=dev)
    if R == 0:
        return rec
    launch = build.bind("slda_predict", "slda_pack_topic_index_launch",
                        _PACK_ARGS)
    with build.on_device(dev):
        rc = launch(idx.data_ptr(), vmask.data_ptr(), occm.data_ptr(),
                    rec.data_ptr(), R, T, cap, build.stream_of(dev))
    build.check_launch("slda_predict", rc)
    return rec


def record_scratch(topic_index, M: int, W: int, T: int, device):
    """The records a sparse launch packs its index into (int32
    [M, W, rw]), or None for the dense draw."""
    if topic_index is None:
        return None
    cap = topic_index[0].shape[-1]
    return torch.empty((M, W, record_layout(T, cap)[3]), dtype=torch.int32,
                       device=device)


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
