"""Speculative decoding: host-side n-gram drafting + acceptance policy
(counterpart of gofr_tpu/spec, copied: the port imports nothing of the
JAX package).

Decode is memory-bandwidth-bound: every output token streams the whole
weight set (plus the live KV prefix) for ONE token of useful work.
Speculative decoding (Leviathan et al., "Fast Inference from Transformers
via Speculative Decoding", 2023) converts the spare FLOPs into multiple
tokens per forward pass: a cheap DRAFTER proposes k tokens, the target
model scores all k+1 positions in one pass (the engine's ``llm.step_v{W}``
program, roughly the cost of one decode step plus a W-wide unembed), and
an acceptance rule keeps the longest prefix the target model agrees with,
output distribution exactly preserved.

This module owns the HOST side of the machinery for gofr_tpu_torch.llm:

- **NGramDrafter**: prompt-lookup drafting (Saxena, "Prompt Lookup
  Decoding", 2023): match the request's trailing n-gram against its own
  prompt + emitted history and propose the continuation of the most
  recent earlier occurrence. No extra device memory and no draft model,
  and effective on repetitive/structured output (code, JSON, extraction,
  quotes).

- **accept_length**: the acceptance rule, host-mirrored for tests (the
  engine evaluates the same rule ON DEVICE inside the verify program, so
  the chain tail and lengths stay device-resident): accept the longest
  prefix where draft[i] == sampled[i]. With the verifier sampling
  position i from the target distribution with the engine's own top-k
  sampler, this IS Leviathan rejection sampling for a deterministic
  drafter; at temperature 0 both sides reduce to argmax and spec-on is
  token-identical to spec-off.

- **draft_len**: per-request adaptive draft length from an acceptance
  EMA: adversarial text backs the draft off to 0 (plain decode) so
  speculation never stays below the spec-off cost, with a periodic
  1-token probe so a request whose tail TURNS repetitive recovers.

Knobs: ``TPU_LLM_SPEC`` (off by default), ``TPU_LLM_SPEC_DRAFT`` (max
draft length, default 4), read by ``LLMEngine`` and ``GPURuntime`` as the
JAX engine and runtime read them.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "NGramDrafter",
    "accept_length",
    "draft_len",
    "SPEC_DRAFT_DEFAULT",
    "SPEC_EMA_ALPHA",
    "SPEC_BACKOFF_EMA",
    "SPEC_PROBE_EVERY",
]

SPEC_DRAFT_DEFAULT = 4  # TPU_LLM_SPEC_DRAFT default (verify width 5)
SPEC_EMA_ALPHA = 0.3  # acceptance-EMA step per verify with proposals
SPEC_BACKOFF_EMA = 0.2  # EMA below this -> plain decode (draft 0)
SPEC_PROBE_EVERY = 16  # backed-off requests probe 1 draft token this often


class NGramDrafter:
    """Prompt-lookup drafter: propose the continuation of the most recent
    earlier occurrence of the sequence's trailing n-gram.

    Longest pattern first (``max_ngram`` down to ``min_ngram``) — a
    longer matched context predicts the continuation better — and within
    a pattern length the MOST RECENT earlier occurrence wins (locality:
    recent text predicts the immediate future better than the distant
    prompt). Pure host-side string matching over the tokens the engine
    already tracks for failover re-seeding, so drafting costs no device
    memory and no extra model.

    The scan runs on the token stream's int32 byte image via
    ``bytes.rfind`` (C speed; a Python token-list scan at 4k-token
    histories costs milliseconds per slot per step, which at 32 slots
    would burn the scheduler thread). Byte matches are validated to
    4-byte token alignment — an unaligned hit (token boundaries
    straddled) re-searches below it.
    """

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if min_ngram < 1 or max_ngram < min_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got {min_ngram}, {max_ngram}"
            )
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def draft(self, tokens: list[int], k: int) -> list[int]:
        """Up to ``k`` proposed continuation tokens for ``tokens`` (the
        request's prompt + emitted history, newest last). Empty when no
        earlier occurrence of any trailing n-gram exists — the engine
        then runs a plain decode step for the slot."""
        t = len(tokens)
        if k <= 0 or t < self.min_ngram + 1:
            return []
        buf = np.asarray(tokens, np.int32).tobytes()
        for n in range(min(self.max_ngram, t - 1), self.min_ngram - 1, -1):
            pat = buf[(t - n) * 4:]
            # Two search ceilings: prefer the most recent occurrence
            # whose continuation has a FULL k tokens before the sequence
            # end (on periodic text pure recency always matches right at
            # the end and truncates the draft to the period), falling
            # back to the most recent occurrence with ANY continuation.
            # A ceiling bounds the END of the match (rfind semantics);
            # match start must be an earlier occurrence, token index
            # <= t - n - 1.
            for last_start in (t - n - k, t - n - 1):
                if last_start < 0:
                    continue
                pos = buf.rfind(pat, 0, last_start * 4 + len(pat))
                while pos != -1 and pos % 4:
                    # unaligned byte hit (token boundaries straddled):
                    # the next candidate must END before this false one
                    pos = buf.rfind(pat, 0, pos + len(pat) - 1)
                if pos == -1:
                    continue
                cont = tokens[pos // 4 + n :][:k]
                if cont:
                    return list(cont)
        return []


def accept_length(draft: list[int], sampled: list[int]) -> int:
    """Longest-agreeing-prefix acceptance: the number of draft tokens
    accepted, ``a = max { j : draft[i] == sampled[i] for all i < j }``.
    The emitted span is then ``sampled[: a + 1]`` — the ``a`` accepted
    draft tokens (each equal to the target model's own sample at its
    position) plus the bonus token sampled at the first disagreeing (or
    final) position, exactly as in Leviathan et al. Host mirror of the
    device-side rule (tests drive both against each other)."""
    a = 0
    for d, s in zip(draft, sampled):
        if d != s:
            break
        a += 1
    return a


def draft_len(ema: float, kmax: int, plain_streak: int) -> int:
    """Adaptive draft length for one request: scale the draft to the
    acceptance EMA, floor at 1 while speculation pays at all, and back
    off to 0 (plain decode — the spec-off baseline cost) once the EMA
    drops below ``SPEC_BACKOFF_EMA``. A backed-off request re-probes
    with a single draft token every ``SPEC_PROBE_EVERY`` plain passes —
    without the probe, one adversarial stretch would disable speculation
    for the request's whole remaining stream even if its tail turns
    repetitive."""
    if kmax <= 0:
        return 0
    if ema < SPEC_BACKOFF_EMA:
        return 1 if plain_streak >= SPEC_PROBE_EVERY else 0
    return max(1, min(kmax, int(round(ema * kmax))))
