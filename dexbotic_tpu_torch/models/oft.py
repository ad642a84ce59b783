"""OFT (OpenVLA-OFT) policies: L1 regression, diffusion and discrete heads
(port of dexbotic_tpu/models/oft.py).

* L1 and Discrete append learned action queries (L1) or the embeddings of
  token id 1 (Discrete) after the prompt and run the LLM once; the hidden
  states at those positions feed an MLPResNet regression head (L1) or
  ``lm_head``'s bin logits (Discrete: parallel decode over the last vocab
  slots).
* Diffusion appends a timestep token and the projected noisy actions; at
  inference the prompt is prefilled into a KV cache once and each DDIM step
  runs the action segment alone against that frozen cache
  (``mot_forward(update_cache=False)``).
* An optional proprio token is prepended to the action segment.

The JAX package's layout is kept: the padded prompt stays in place and the
segment is appended after its padding, with groups ``cumsum(valid)`` and
positions ``groups - 1``, so the pads sit mid-row with the group of the last
prompt token.  On a CUDA device every decoder attention call is kernel K1
(head_dim 128 for LLaMA-2) and its gradient kernel K3; under int8 serving
the quantized products are kernel K4.  The MLPResNet reads the hidden states
in fp32 and computes in fp32, as in JAX.  Randomness (diffusion times and
noise, sampled bins) comes from an explicit ``torch.Generator``, or is
injected.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dexbotic_tpu_torch.models.vlm import VLM, VLMConfig, encode_images, init_vlm_, splice_image_embeds
from dexbotic_tpu_torch.nn import core
from dexbotic_tpu_torch.nn.transformer import Stream, lm_logits, mot_forward
from dexbotic_tpu_torch.ops.diffusion import DiffusionSchedule
from dexbotic_tpu_torch.ops.norms import LayerNorm


@dataclasses.dataclass(frozen=True)
class OFTConfig:
    vlm: VLMConfig
    action_model_type: str = "L1"  # 'L1' | 'Diffusion' | 'Discrete'
    action_dim: int = 7
    chunk_size: int = 16
    use_proprio: bool = False
    proprio_dim: Optional[int] = None
    num_bins: int = 256
    num_diffusion_steps: int = 100
    ddim_steps: int = 10
    # the reference's discrete decode reads the last num_bins - 1 vocab slots
    # while mapping with a (num_bins - 1) denominator: every decoded action is
    # one bin off the training labels.  True replays released weights bin for
    # bin; False reads the full num_bins range.
    reference_parity: bool = True

    @property
    def num_action_tokens(self) -> int:
        return self.chunk_size * self.action_dim

    @property
    def hidden(self) -> int:
        return self.vlm.llm.hidden_size

    @property
    def segment_len(self) -> int:
        """Tokens appended after the padded prompt."""
        return (self.num_action_tokens + ("Diffusion" in self.action_model_type)
                + self.use_proprio)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class UnstackedList(nn.ModuleList):
    """A ``blocks`` list that is a Python list in the JAX tree, not a layer
    stack on a leading axis: int8 quantization sizes each block alone."""

    jax_stacked = False


class _ResBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.ln = LayerNorm(dim, eps=1e-5)
        self.fc = core.Linear(dim, dim)


class MLPResNet(nn.Module):
    """LayerNorm, fc1 + ReLU, residual ReLU blocks, LayerNorm, fc2 (the
    reference's action_model/model.py:83-126)."""

    def __init__(self, num_blocks: int, input_dim: int, hidden_dim: int, output_dim: int):
        super().__init__()
        self.ln1 = LayerNorm(input_dim, eps=1e-5)
        self.fc1 = core.Linear(input_dim, hidden_dim)
        self.ln2 = LayerNorm(hidden_dim, eps=1e-5)
        self.fc2 = core.Linear(hidden_dim, output_dim)
        self.blocks = UnstackedList(_ResBlock(hidden_dim) for _ in range(num_blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.fc1(self.ln1(x)))
        for blk in self.blocks:
            x = x + F.relu(blk.fc(blk.ln(x)))
        return self.fc2(self.ln2(x))


class _Projector2(nn.Module):
    """fc1 -> exact GELU -> fc2 (the proprio and noisy-action projectors)."""

    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.fc1 = core.Linear(in_dim, dim)
        self.fc2 = core.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class OFTHead(nn.Module):
    """The head's parameters under the JAX names: ``action_query`` + ``mlp``
    (L1), ``noisy_action_projector`` + ``noise_predictor`` (Diffusion), none
    (Discrete), and ``proprio_projector`` with proprio."""

    def __init__(self, cfg: OFTConfig):
        super().__init__()
        H, t = cfg.hidden, cfg.action_model_type
        if "L1" in t:
            self.action_query = nn.Parameter(torch.zeros(cfg.num_action_tokens, H))
            self.mlp = MLPResNet(2, H * cfg.action_dim, H, cfg.action_dim)
        elif "Diffusion" in t:
            self.noisy_action_projector = _Projector2(1, H)
            self.noise_predictor = MLPResNet(2, H * cfg.action_dim, H, cfg.action_dim)
        elif "Discrete" not in t:
            raise ValueError(t)
        if cfg.use_proprio:
            self.proprio_projector = _Projector2(cfg.proprio_dim, H)


class OFT(nn.Module):
    def __init__(self, cfg: OFTConfig):
        super().__init__()
        self.vlm = VLM(cfg.vlm)
        self.action_head = OFTHead(cfg)


@torch.no_grad()
def init_oft_head_(head: OFTHead, gen: torch.Generator) -> None:
    """The JAX init's distributions: torch-style uniform linears, identity
    LayerNorms, zero action queries."""
    core.init_linears_(head, gen)
    core.reset_norms_(head)
    if hasattr(head, "action_query"):
        head.action_query.zero_()


@torch.no_grad()
def init_oft_(model: OFT, gen: torch.Generator) -> None:
    init_vlm_(model.vlm, gen)
    init_oft_head_(model.action_head, gen)


def _materialise(make: Callable[[], nn.Module], init_, device, seed: int,
                 prepare: Optional[Callable[[nn.Module], nn.Module]]) -> nn.Module:
    device = torch.device(device)
    with torch.device("meta"):
        mod = make()
    if prepare is not None:
        mod = prepare(mod)
    mod = mod.to_empty(device=device)
    init_(mod, torch.Generator(device=device).manual_seed(seed))
    return mod.eval().requires_grad_(False)


def build_oft(cfg: OFTConfig, device, seed: int = 0,
              prepare: Optional[Callable[[nn.Module], nn.Module]] = None) -> OFT:
    """Seeded random OFT policy built in place on ``device``: laid out on the
    meta device, recast by ``prepare`` (a dtype policy), then materialised
    and initialised there, as ``models/cogact.build_cogact``."""
    return _materialise(lambda: OFT(cfg), init_oft_, device, seed, prepare)


def build_oft_head(cfg: OFTConfig, device, seed: int = 0,
                   prepare: Optional[Callable[[nn.Module], nn.Module]] = None) -> OFTHead:
    """A seeded random head alone, to put on a built model's VLM
    (``model.action_head = ...``) with the config of that head."""
    return _materialise(lambda: OFTHead(cfg), init_oft_head_, device, seed, prepare)


def sinusoidal_time_encoding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusion-policy [sin, cos] of integer timesteps [B] -> [B, dim] fp32."""
    half = dim // 2
    exponent = torch.arange(half, dtype=torch.float32, device=t.device) * (
        -np.log(10000.0) / (half - 1))
    emb = t.float()[:, None] * torch.exp(exponent)[None, :]
    return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)


def schedule(cfg: OFTConfig) -> DiffusionSchedule:
    return DiffusionSchedule.create(cfg.num_diffusion_steps)


# ---------------------------------------------------------------------------
# Prompt + appended action segment through the LLM
# ---------------------------------------------------------------------------


def prompt_embeds(model: OFT, cfg: OFTConfig, input_ids, images, remat=False) -> torch.Tensor:
    feats = encode_images(model.vlm, cfg.vlm, images, remat=remat)
    return splice_image_embeds(model.vlm, cfg.vlm, input_ids, feats)


def action_segment(model: OFT, cfg: OFTConfig, B: int, dtype, states=None, noisy=None,
                   time_emb=None) -> torch.Tensor:
    """The appended segment [proprio?; time?; action tokens] [B, A, H]."""
    head, t = model.action_head, cfg.action_model_type
    if "L1" in t:
        seg = head.action_query.to(dtype)[None].expand(B, -1, -1)
    elif "Diffusion" in t:
        na = noisy.reshape(B, cfg.num_action_tokens, 1).to(dtype)
        seg = head.noisy_action_projector(na)
        seg = torch.cat([time_emb.to(dtype)[:, None, :], seg], dim=1)
    else:  # Discrete: embeddings of token id 1 (int8 rows under an int8 table)
        table = model.vlm.llm.embed
        ones = torch.ones((B, cfg.num_action_tokens), dtype=torch.long,
                          device=next(table.parameters()).device)
        seg = core.embed(table, ones).to(dtype)
    if cfg.use_proprio:
        st = head.proprio_projector(states.to(dtype))
        seg = torch.cat([st.reshape(B, -1, cfg.hidden), seg], dim=1)
    return seg


def run_with_segment(model: OFT, cfg: OFTConfig, prompt: Optional[torch.Tensor],
                     prompt_valid: torch.Tensor, segment: torch.Tensor,
                     cache: Optional[dict] = None, remat=False) -> torch.Tensor:
    """Hidden states at the segment's positions [B, A, H].

    Without ``cache`` the segment is appended after the padded prompt and
    both run jointly; with one (:func:`prefill_prompt`'s) the segment runs
    alone against the frozen prompt cache, its groups from ``prompt_len + 1``
    and its positions from ``prompt_len``."""
    B, A = segment.shape[:2]
    pv = prompt_valid.to(torch.int32)
    seg_valid = torch.ones((B, A), dtype=torch.int32, device=segment.device)
    stream = model.vlm.llm
    if cache is None:
        embeds = torch.cat([prompt, segment], dim=1)
        valid = torch.cat([pv, seg_valid], dim=1)
        grp = torch.cumsum(valid, dim=1, dtype=torch.int32)
        outs, _ = mot_forward([Stream(cfg.vlm.llm, stream, embeds)], positions=grp - 1,
                              q_grp=grp, q_valid=valid, remat=remat)
        return outs[0][:, -A:]
    prompt_len = pv.sum(dim=1, keepdim=True, dtype=torch.int32)
    grp = prompt_len + torch.cumsum(seg_valid, dim=1, dtype=torch.int32)
    outs, _ = mot_forward([Stream(cfg.vlm.llm, stream, segment)], positions=grp - 1,
                          q_grp=grp, q_valid=seg_valid, cache=cache, update_cache=False)
    return outs[0][:, -A:]


def prefill_prompt(model: OFT, cfg: OFTConfig, prompt: torch.Tensor,
                   prompt_valid: torch.Tensor) -> dict:
    """The prompt's KV cache (its pads marked invalid), filled in one forward."""
    pv = prompt_valid.to(torch.int32)
    grp = torch.cumsum(pv, dim=1, dtype=torch.int32)
    _, cache = mot_forward([Stream(cfg.vlm.llm, model.vlm.llm, prompt)], positions=grp - 1,
                           q_grp=grp, q_valid=pv, update_cache=True)
    return cache


def _head_input(hid: torch.Tensor, cfg: OFTConfig, skip: int) -> torch.Tensor:
    """Segment hidden states past the first ``skip`` tokens -> [B, chunk,
    action_dim * H] fp32, the MLPResNet's input."""
    return hid[:, skip:].reshape(hid.shape[0], cfg.chunk_size, -1).float()


def _bin_logits(model: OFT, cfg: OFTConfig, hid: torch.Tensor) -> torch.Tensor:
    return lm_logits(model.vlm.llm, cfg.vlm.llm, hid[:, int(cfg.use_proprio):]).float()


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def oft_loss(model: OFT, cfg: OFTConfig, batch: dict, generator: Optional[torch.Generator] = None,
             remat=False, diffusion_t: Optional[torch.Tensor] = None,
             diffusion_noise: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, dict]:
    """L1 / diffusion MSE / discrete cross-entropy training loss.  Diffusion
    draws its timesteps and noise from ``generator`` unless injected."""
    B = batch["input_ids"].shape[0]
    actions = batch["actions"].reshape(B, -1, cfg.action_dim)[:, : cfg.chunk_size].float()
    states = batch.get("states")
    prompt = prompt_embeds(model, cfg, batch["input_ids"], batch["images"], remat=remat)
    valid = batch["attention_mask"]
    t = cfg.action_model_type

    if "Diffusion" in t:
        sched = schedule(cfg)
        ts = diffusion_t
        if ts is None:
            ts = torch.randint(0, cfg.num_diffusion_steps, (B,), generator=generator,
                               device=actions.device)
        noise = diffusion_noise
        if noise is None:
            noise = torch.randn(actions.shape, generator=generator, dtype=torch.float32,
                                device=actions.device)
        noisy = sched.q_sample(actions, ts, noise.float())
        seg = action_segment(model, cfg, B, prompt.dtype, states, noisy,
                             sinusoidal_time_encoding(ts, cfg.hidden))
        hid = run_with_segment(model, cfg, prompt, valid, seg, remat=remat)
        pred = model.action_head.noise_predictor(_head_input(hid, cfg, 1 + cfg.use_proprio))
        loss = torch.mean(torch.square(pred - noise.float()))
        return loss, {"action_loss": loss, "loss": loss}

    seg = action_segment(model, cfg, B, prompt.dtype, states)
    hid = run_with_segment(model, cfg, prompt, valid, seg, remat=remat)
    if "L1" in t:
        pred = model.action_head.mlp(_head_input(hid, cfg, int(cfg.use_proprio)))
        loss = torch.mean(torch.abs(actions - pred))
        return loss, {"action_loss": loss, "loss": loss}

    # Discrete: cross-entropy over the bin labels (vocab slots)
    logp = torch.log_softmax(_bin_logits(model, cfg, hid), dim=-1)
    labels = batch["action_bins"].reshape(B, -1).long()
    loss = -torch.gather(logp, -1, labels[..., None])[..., 0].mean()
    return loss, {"action_loss": loss, "loss": loss}


# ---------------------------------------------------------------------------
# Inference
# ---------------------------------------------------------------------------


@torch.no_grad()
def oft_inference_action(model: OFT, cfg: OFTConfig, input_ids, valid, images, states=None,
                         generator: Optional[torch.Generator] = None,
                         ddim_steps: Optional[int] = None,
                         noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Normalised action chunk [B, chunk, action_dim] fp32.  Diffusion draws
    its initial noise from ``generator`` unless ``noise`` is given."""
    t = cfg.action_model_type
    if "Discrete" in t:
        logits = discrete_bin_logits(model, cfg, input_ids, valid, images, states)
        return bins_to_continuous(logits.argmax(-1), cfg)

    B = input_ids.shape[0]
    prompt = prompt_embeds(model, cfg, input_ids, images)
    if "L1" in t:
        hid = run_with_segment(model, cfg, prompt, valid, action_segment(model, cfg, B, prompt.dtype,
                                                                         states))
        return model.action_head.mlp(_head_input(hid, cfg, int(cfg.use_proprio)))

    # Diffusion: the prompt prefilled once, DDIM over the segment alone
    cache = prefill_prompt(model, cfg, prompt, valid)
    if noise is None:
        noise = torch.randn((B, cfg.chunk_size, cfg.action_dim), generator=generator,
                            dtype=torch.float32, device=prompt.device)
    skip = 1 + cfg.use_proprio

    def eps_fn(x, ts):
        seg = action_segment(model, cfg, B, prompt.dtype, states, x,
                             sinusoidal_time_encoding(ts, cfg.hidden))
        hid = run_with_segment(model, cfg, None, valid, seg, cache=cache)
        return model.action_head.noise_predictor(_head_input(hid, cfg, skip))

    return schedule(cfg).ddim_sample(eps_fn, noise, ddim_steps or cfg.ddim_steps)


def decode_slots(cfg: OFTConfig) -> int:
    """Trailing vocab slots read at discrete decode: num_bins - 1 under
    ``reference_parity`` (the reference's ``[-num_bins+1:]``), else num_bins."""
    return cfg.num_bins - 1 if cfg.reference_parity else cfg.num_bins


def bins_to_continuous(bins: torch.Tensor, cfg: OFTConfig) -> torch.Tensor:
    """Bin indices -> [-1, 1], [B, chunk, action_dim] fp32."""
    a = bins.reshape(bins.shape[0], cfg.chunk_size, cfg.action_dim).float()
    return (a / (cfg.num_bins - 1)) * 2.0 - 1.0


def continuous_to_bins(actions: torch.Tensor, cfg: OFTConfig) -> torch.Tensor:
    a = torch.clamp(actions, -1.0, 1.0)
    return torch.round((a + 1) / 2 * (cfg.num_bins - 1)).to(torch.int32)


def discrete_bin_logits(model, cfg, input_ids, valid, images, states, temperature=1.0,
                        remat=False) -> torch.Tensor:
    """The Discrete head's fp32 logits over the decoded vocab slots [B,
    chunk * action_dim, decode_slots], divided by ``temperature``."""
    B = input_ids.shape[0]
    prompt = prompt_embeds(model, cfg, input_ids, images, remat=remat)
    seg = action_segment(model, cfg, B, prompt.dtype, states)
    hid = run_with_segment(model, cfg, prompt, valid, seg, remat=remat)
    return _bin_logits(model, cfg, hid)[..., -decode_slots(cfg):] / temperature


@torch.no_grad()
def oft_generate_action(model: OFT, cfg: OFTConfig, input_ids, valid, images, states,
                        generator: Optional[torch.Generator] = None, temperature: float = 1.0):
    """Sampled parallel discrete decode (RL rollouts): (actions, bins, log-probs
    of the drawn bins); the bins are drawn from ``generator``."""
    if "Discrete" not in cfg.action_model_type:
        raise ValueError("oft_generate_action needs the Discrete head")
    logits = discrete_bin_logits(model, cfg, input_ids, valid, images, states, temperature)
    logp = torch.log_softmax(logits, dim=-1)
    flat = torch.softmax(logits, dim=-1).reshape(-1, logits.shape[-1])
    bins = torch.multinomial(flat, 1, generator=generator).reshape(logits.shape[:-1])
    chosen = torch.gather(logp, -1, bins[..., None])[..., 0]
    return bins_to_continuous(bins, cfg), bins, chosen


def oft_action_log_probs(model: OFT, cfg: OFTConfig, input_ids, valid, images, states, bins,
                         temperature: float = 1.0, remat=False):
    """(log-probs of the given bins, entropy) under the current weights: the RL
    recompute-logprob path; ``remat`` checkpoints the tower and decoder."""
    logits = discrete_bin_logits(model, cfg, input_ids, valid, images, states, temperature, remat)
    logp = torch.log_softmax(logits, dim=-1)
    chosen = torch.gather(logp, -1, bins.long()[..., None])[..., 0]
    entropy = -(logp.exp() * logp).sum(-1)
    return chosen, entropy
