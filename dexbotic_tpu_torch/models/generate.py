"""Autoregressive text generation: one prefill, then a fixed-length decode
loop (port of dexbotic_tpu/models/generate.py).

The prompt fills a bf16 KV cache of S + max_new_tokens columns, whatever the
weights' dtype, as the JAX package builds it; then max_new_tokens steps each
draw one token a row (greedy at temperature 0, else from the softmax at that
temperature with a ``torch.Generator``), feed it back as one query row
against the cache and write its K/V there.  The loop never stops early: a row
that has drawn the EOS id writes the pad id after it, with its step marked
invalid, so that it stays out of every later token's attention.  Positions
and attention groups continue from each row's true prompt length
(``grp = pos + 1``), so right-padding shifts no RoPE.  On a CUDA device the
prefill and every decode step are kernel K1 (one query row a step).
"""

from __future__ import annotations

from typing import Optional

import torch

from dexbotic_tpu_torch.models.vlm import VLM, VLMConfig, vlm_forward
from dexbotic_tpu_torch.nn.transformer import embed_tokens, init_kv_cache, lm_logits


@torch.no_grad()
def generate(vlm: VLM, cfg: VLMConfig, input_ids: torch.Tensor, valid: torch.Tensor,
             images: Optional[torch.Tensor], max_new_tokens: int, eos_token_id: int,
             pad_token_id: int = 0, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             inputs_embeds: Optional[torch.Tensor] = None):
    """(tokens int32 [B, max_new_tokens], logprobs fp32 [B, max_new_tokens]).

    ``input_ids`` [B, S] is the right-padded prompt, ``valid`` its mask;
    ``inputs_embeds`` replaces the embedding and image splice of the prompt.
    A logprob is the drawn token's under the step's logits (the pad that
    replaces it after EOS has none of its own).  The last step's token is
    drawn and not fed back: the JAX scan runs one more forward whose output
    nothing reads."""
    B, S = input_ids.shape
    valid = valid.to(torch.int32)
    cache = init_kv_cache(cfg.llm, B, S + max_new_tokens, dtype=torch.bfloat16,
                          device=input_ids.device)
    hidden, cache = vlm_forward(vlm, cfg, input_ids, valid, images=images,
                                inputs_embeds=inputs_embeds, cache=cache, update_cache=True)
    prompt_len = valid.sum(1, dtype=torch.int32)
    rows = torch.arange(B, device=input_ids.device)
    prev = hidden[rows, prompt_len.long() - 1]
    done = torch.zeros(B, dtype=torch.bool, device=input_ids.device)
    tokens, logps = [], []
    for t in range(max_new_tokens):
        logits = lm_logits(vlm.llm, cfg.llm, prev).float()
        if temperature and temperature > 0:
            probs = torch.softmax(logits / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            tok = logits.argmax(-1)
        logp = torch.log_softmax(logits, -1).gather(-1, tok[:, None])[:, 0]
        tok = torch.where(done, pad_token_id, tok).to(torch.int32)
        tokens.append(tok)
        logps.append(logp)
        if t == max_new_tokens - 1:
            break
        step_valid = (~done).to(torch.int32)[:, None]
        done = done | (tok == eos_token_id)
        emb = embed_tokens(vlm.llm, cfg.llm, tok[:, None], dtype=prev.dtype)
        pos = (prompt_len + t)[:, None]
        hidden, cache = vlm_forward(vlm, cfg, tok[:, None], step_valid, inputs_embeds=emb,
                                    positions=pos, grp=pos + 1, cache=cache, update_cache=True)
        prev = hidden[:, 0]
    return torch.stack(tokens, 1), torch.stack(logps, 1)
