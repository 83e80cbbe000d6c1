"""Architecture registry of the port: shape tables only, no weights; and
the paper's own sLDA experiment configs.

The frontend-free, expert-free archs of the reference's registry are
here: the dense ones, Mamba-2 and the hybrid.  The others raise
`NotImplementedError` naming the ROADMAP item that brings them.
"""
from __future__ import annotations

from repro_torch.core.types import SLDAConfig

from . import (codeqwen1_5_7b, internlm2_1_8b, mamba2_1_3b, qwen2_5_32b,
               qwen3_1_7b, zamba2_2_7b)

_MODULES = {
    "qwen2.5-32b": qwen2_5_32b,
    "codeqwen1.5-7b": codeqwen1_5_7b,
    "internlm2-1.8b": internlm2_1_8b,
    "qwen3-1.7b": qwen3_1_7b,
    "mamba2-1.3b": mamba2_1_3b,
    "zamba2-2.7b": zamba2_2_7b,
}

ARCHS = {name: m.CONFIG for name, m in _MODULES.items()}
SMOKES = {name: m.SMOKE for name, m in _MODULES.items()}

NOT_PORTED = {
    "arctic-480b": "MoE",
    "phi3.5-moe-42b-a6.6b": "MoE",
    "internvl2-2b": "the vision frontend",
    "musicgen-medium": "the audio frontend",
}


def get_arch(name: str, smoke: bool = False):
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"{name}: {NOT_PORTED[name]} comes with ROADMAP queue A item 15")
    table = SMOKES if smoke else ARCHS
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; have {sorted(table)}")
    return table[name]


# ---- the paper's own experiments (Section IV), the reference's values
SLDA_MDNA = SLDAConfig(n_topics=32, vocab_size=4238, rho=0.5,
                       label_type="continuous", n_iters=60)
SLDA_IMDB = SLDAConfig(n_topics=32, vocab_size=8000, rho=0.25,
                       label_type="binary", n_iters=60)

__all__ = ["ARCHS", "SMOKES", "NOT_PORTED", "get_arch", "SLDA_MDNA",
           "SLDA_IMDB"]
