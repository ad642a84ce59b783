"""Discrete VLA (OpenVLA-style): plain autoregressive text, parsed into
integer action bins (port of dexbotic_tpu/models/discrete_vla.py).

The answer is a string of ``action_dim`` integers (``ActionNormAnd2String``'s
bins); training is the causal LM loss on it.  Inference decodes greedily,
parses the first ``action_dim`` integers and maps the bins to [-1, 1]; on a
parse failure it retries with sampling at temperature 1.0 (draws from a
``torch.Generator``), up to ``max_retries`` times, then answers zeros.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from dexbotic_tpu_torch.models.generate import generate
from dexbotic_tpu_torch.models.losses import causal_lm_loss
from dexbotic_tpu_torch.models.vlm import VLM, VLMConfig, init_vlm_, vlm_forward
from dexbotic_tpu_torch.nn.transformer import lm_logits


@dataclasses.dataclass(frozen=True)
class DiscreteVLAConfig:
    vlm: VLMConfig
    action_dim: int = 7
    vocab_bins: int = 255
    max_new_tokens: int = 32
    max_retries: int = 40


class DiscreteVLA(nn.Module):
    def __init__(self, cfg: DiscreteVLAConfig):
        super().__init__()
        self.vlm = VLM(cfg.vlm)


def build_discrete_vla(cfg: DiscreteVLAConfig, device, seed: int = 0,
                       prepare: Optional[Callable[[nn.Module], nn.Module]] = None) -> DiscreteVLA:
    """Seeded random Discrete VLA built in place on ``device`` (laid out on
    the meta device, recast by ``prepare``, then materialised and initialised)."""
    device = torch.device(device)
    with torch.device("meta"):
        model = DiscreteVLA(cfg)
    if prepare is not None:
        model = prepare(model)
    model = model.to_empty(device=device)
    with torch.no_grad():
        init_vlm_(model.vlm, torch.Generator(device=device).manual_seed(seed))
    return model.eval().requires_grad_(False)


def discrete_vla_loss(model: DiscreteVLA, cfg: DiscreteVLAConfig, batch: dict, generator=None,
                      remat=False):
    """Next-token CE on the tokenized action-string answer."""
    hidden = vlm_forward(model.vlm, cfg.vlm, batch["input_ids"], batch["attention_mask"],
                         images=batch["images"], remat=remat)
    loss = causal_lm_loss(lm_logits(model.vlm.llm, cfg.vlm.llm, hidden), batch["labels"])
    return loss, {"text_loss": loss, "loss": loss}


def parse_action_text(text: str, action_dim: int, vocab_bins: int) -> Optional[np.ndarray]:
    """The first ``action_dim`` integers of ``text`` as bins, mapped to
    [-1, 1]; None when there are fewer."""
    nums = re.findall(r"\d+", text)
    if len(nums) < action_dim:
        return None
    bins = np.array([int(n) for n in nums[:action_dim]], dtype=np.float64)
    bins = np.clip(bins, 0, vocab_bins - 1)
    return bins / (vocab_bins - 1) * 2.0 - 1.0


@torch.no_grad()
def discrete_vla_inference_action(model: DiscreteVLA, cfg: DiscreteVLAConfig, tokenizer,
                                  input_ids: torch.Tensor, valid: torch.Tensor,
                                  images: torch.Tensor, eos_token_id: int,
                                  generator: Optional[torch.Generator] = None,
                                  stats: Optional[dict] = None) -> np.ndarray:
    """Greedy decode, then sampled retries on a parse failure; zeros after
    ``max_retries``.  ``stats``, when given, receives the number of
    ``generate`` calls ("generate_calls") and whether a text parsed ("parsed")."""

    def decode(temperature: float):
        tokens, _ = generate(model.vlm, cfg.vlm, input_ids, valid, images, cfg.max_new_tokens,
                             eos_token_id, temperature=temperature, generator=generator)
        text = tokenizer.decode([t for t in tokens[0].tolist() if t >= 0])
        return parse_action_text(text, cfg.action_dim, cfg.vocab_bins)

    action, tries = decode(0.0), 0
    while action is None and tries < cfg.max_retries:
        action = decode(1.0)
        tries += 1
    if stats is not None:
        stats.update(generate_calls=1 + tries, parsed=action is not None)
    return np.zeros((cfg.action_dim,)) if action is None else action
