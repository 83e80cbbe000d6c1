"""Architecture registry of the port: shape tables only, no weights; and
the paper's own sLDA experiment configs.

Every arch of the reference's registry is here: the dense ones, the
MoE ones, Mamba-2, the hybrid and the two stub frontends, each with its
`CONFIG`, its `SMOKE` configuration and the reference's `RUN` settings.
"""
from __future__ import annotations

from repro_torch.core.types import SLDAConfig

from . import (arctic_480b, codeqwen1_5_7b, internlm2_1_8b, internvl2_2b,
               mamba2_1_3b, musicgen_medium, phi3_5_moe_42b, qwen2_5_32b,
               qwen3_1_7b, zamba2_2_7b)

_MODULES = {
    "qwen2.5-32b": qwen2_5_32b,
    "codeqwen1.5-7b": codeqwen1_5_7b,
    "internlm2-1.8b": internlm2_1_8b,
    "qwen3-1.7b": qwen3_1_7b,
    "arctic-480b": arctic_480b,
    "phi3.5-moe-42b-a6.6b": phi3_5_moe_42b,
    "zamba2-2.7b": zamba2_2_7b,
    "internvl2-2b": internvl2_2b,
    "musicgen-medium": musicgen_medium,
    "mamba2-1.3b": mamba2_1_3b,
}

ARCHS = {name: m.CONFIG for name, m in _MODULES.items()}
SMOKES = {name: m.SMOKE for name, m in _MODULES.items()}
RUNS = {name: m.RUN for name, m in _MODULES.items()}


def get_arch(name: str, smoke: bool = False):
    table = SMOKES if smoke else ARCHS
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; have {sorted(table)}")
    return table[name]


# ---- the paper's own experiments (Section IV), the reference's values
SLDA_MDNA = SLDAConfig(n_topics=32, vocab_size=4238, rho=0.5,
                       label_type="continuous", n_iters=60)
SLDA_IMDB = SLDAConfig(n_topics=32, vocab_size=8000, rho=0.25,
                       label_type="binary", n_iters=60)

__all__ = ["ARCHS", "SMOKES", "RUNS", "get_arch", "SLDA_MDNA",
           "SLDA_IMDB"]
