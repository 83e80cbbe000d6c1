"""Batched generation with the paper's prediction combination at the
token level.

A `ServingEngine` owns a model and its slot-based KV cache: requests
occupy fixed batch slots.  At every step the next-token distributions of
the n_chains replicas are combined by Simple or Weighted Average (the
paper's Eqs. 7 and 9); a chain's weight of 0 (`drop_chain`) cuts it from
the mix, as a straggler or a failed chain is cut.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0          # 0 = greedy
    top_k: int = 0                    # 0 = off
    combine: str = "simple"           # "simple" | "weighted" | "none"
    eos_id: int = -1                  # -1 = never stop early


def sample_token(logits, temperature: float = 0.0, top_k: int = 0,
                 generator=None):
    """logits [..., V] → int32 token ids [...].

    Greedy takes the first maximal index.  Top-k keeps exactly k
    candidates, ties at the k-th value broken by index order (a stable
    descending sort, as `jax.lax.top_k` orders them); k is clamped to V.
    A sampled token is the Gumbel-max draw on `generator` (by default
    torch's own), so it does not reproduce JAX's stream."""
    if temperature <= 0.0:
        return logits.argmax(-1).to(torch.int32)
    logits = logits / temperature
    if top_k > 0:
        k = min(top_k, logits.shape[-1])
        vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
        logits = torch.full_like(logits, -1e30).scatter(
            -1, idx[..., :k], vals[..., :k])
    src = generator.device if generator is not None else logits.device
    u = torch.rand(logits.shape, generator=generator, device=src)
    gumbel = -torch.log(-torch.log(u.to(logits.device)))
    return (logits + gumbel).argmax(-1).to(torch.int32)


class ServingEngine:
    """Greedy or sampled generation over a fixed slot batch."""

    def __init__(self, model, *, batch_slots: int, max_len: int,
                 gen: GenerationConfig, chain_weights=None,
                 compute_dtype=torch.float32):
        self.model = model
        self.gen = gen
        self.n_chains = model.n_chains
        self.batch = batch_slots
        self.max_len = max_len
        self.compute_dtype = compute_dtype
        dev = model.final_norm.device
        self.chain_weights = (
            torch.ones(self.n_chains, device=dev) if chain_weights is None
            else torch.as_tensor(chain_weights, dtype=torch.float32,
                                 device=dev).clone())
        self.reset()

    def reset(self):
        """An empty cache: the next `generate` starts a fresh stream."""
        self.cache = self.model.init_cache(self.batch, self.max_len,
                                           self.compute_dtype)

    # ------------------------------------------------------------- internals
    def _combine(self, logits, chain_weights):
        """[c, b, 1, V] → [b, V] by the configured rule.

        Both rules honour the alive mask that `chain_weights` implies:
        Simple Average is the mean over the surviving chains, Weighted
        Average renormalises the weights; with every chain dropped both
        fall back to the unmasked rule.  "none" serves the first alive
        chain (chain 0 if none is alive)."""
        if self.gen.combine == "none" or self.n_chains == 1:
            first_alive = (chain_weights > 0).to(torch.int32).argmax()
            return logits[first_alive, :, 0].to(torch.float32)
        probs = torch.softmax(logits.to(torch.float32), dim=-1)
        if self.gen.combine == "simple":
            alive = (chain_weights > 0).to(torch.float32)
            alive = torch.where(alive.sum() > 0, alive,
                                torch.ones_like(alive))
            mix = torch.einsum("c,cbsv->bsv", alive, probs) \
                / alive.sum().clamp(min=1.0)
        else:
            w = torch.where(chain_weights.sum() > 0, chain_weights,
                            torch.ones_like(chain_weights))
            w = w / w.sum().clamp(min=1e-9)
            mix = torch.einsum("c,cbsv->bsv", w, probs)
        return torch.log(mix[:, 0].clamp(min=1e-30))

    def _decode(self, tokens, generator):
        """One step: tokens [c, b, 1] → (the next tokens fed back
        [c, b, 1], the combined next token [b])."""
        logits, self.cache = self.model.decode_step(
            self.cache, tokens, compute_dtype=self.compute_dtype)
        nxt = sample_token(self._combine(logits, self.chain_weights),
                           self.gen.temperature, self.gen.top_k, generator)
        return self._fed_back(nxt), nxt

    def _fed_back(self, nxt):
        return nxt[None, :, None].expand(self.n_chains, self.batch,
                                         1).to(torch.int32)

    # ---------------------------------------------------------------- public
    def prefill(self, prompts):
        """prompts int [b, s0]: every chain's cache is primed by running
        the prompt through decode steps.  Returns the last prompt token
        [c, b, 1], which `generate` feeds first, as the reference does
        (so that token sits in the cache twice: ROADMAP section C)."""
        toks = prompts[None].expand((self.n_chains,) + tuple(prompts.shape))
        toks = toks.to(torch.int32)
        for t in range(prompts.shape[1]):
            _, self.cache = self.model.decode_step(
                self.cache, toks[:, :, t:t + 1],
                compute_dtype=self.compute_dtype)
        return toks[:, :, -1:]

    def generate(self, prompts, generator=None, timer=None):
        """prompts int [b, s0] → generated int32 [b, max_new_tokens].

        With `gen.eos_id >= 0` a slot that emits EOS is frozen: its later
        columns are eos_id and the token fed back stays eos_id.  The loop
        stops once every slot is done; the output is eos-padded.
        `timer` (a `timing.PhaseTimer`) gets a "prefill" span and one
        "decode" span per step."""
        phase = timer or (lambda name: contextlib.nullcontext())
        eos = self.gen.eos_id
        with phase("prefill"):
            tok = self.prefill(prompts)
        out = []
        done = torch.zeros(prompts.shape[0], dtype=torch.bool,
                           device=tok.device)
        for i in range(self.gen.max_new_tokens):
            with phase("decode"):
                tok, nxt = self._decode(tok, generator)
            if eos >= 0:
                nxt = torch.where(done, torch.full_like(nxt, eos), nxt)
                tok = self._fed_back(nxt)
                done = done | (nxt == eos)
            out.append(nxt)
            if eos >= 0 and bool(done.all()):
                out.extend([torch.full_like(nxt, eos)]
                           * (self.gen.max_new_tokens - i - 1))
                break
        return torch.stack(out, dim=1)

    def drop_chain(self, idx: int):
        """Serving-time straggler or failure cut: the chain's weight goes
        to 0 and the combiner renormalises over the others."""
        self.chain_weights[idx] = 0.0

    def revive_chain(self, idx: int, weight: float = 1.0):
        """Undo a drop: chains share nothing, so restoring the weight is
        exact."""
        self.chain_weights[idx] = weight
