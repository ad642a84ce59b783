"""Named architecture presets (port of dexbotic_tpu/models/presets.py).

Plain config values, not weights: the backbones (LLaMA-2-7B for CogACT,
Qwen2/Qwen3, Gemma-2B for PaliGemma), the action experts (Gemma-300M with and
without adaRMS, Qwen3-0.6B), the towers (CLIP-L/336, SigLIP so400m) and the
CI-sized ``*_TEST`` variants.
"""

from __future__ import annotations

import dataclasses

from dexbotic_tpu_torch.nn.transformer import TransformerConfig
from dexbotic_tpu_torch.nn.vit import (  # noqa: F401 (re-export)
    CLIP_VIT_L_336,
    SIGLIP_SO400M_224,
    SIGLIP_SO400M_384,
    ViTConfig,
)

# --------------------------------------------------------------------------
# LLM backbones
# --------------------------------------------------------------------------

LLAMA2_7B = TransformerConfig(  # CogACT's LLaVA/vicuna-7B backbone
    vocab_size=32000, hidden_size=4096, num_layers=32, num_heads=32,
    num_kv_heads=32, head_dim=128, intermediate_size=11008,
    act="silu", rope_theta=10000.0, rms_eps=1e-5, tie_embeddings=False,
)

QWEN2_7B = TransformerConfig(
    vocab_size=152064, hidden_size=3584, num_layers=28, num_heads=28,
    num_kv_heads=4, head_dim=128, intermediate_size=18944,
    act="silu", rope_theta=1e6, rms_eps=1e-6, attn_bias=True, tie_embeddings=False,
)

QWEN2_05B = TransformerConfig(
    vocab_size=151936, hidden_size=896, num_layers=24, num_heads=14,
    num_kv_heads=2, head_dim=64, intermediate_size=4864,
    act="silu", rope_theta=1e6, rms_eps=1e-6, attn_bias=True, tie_embeddings=True,
)

QWEN3_1_7B = TransformerConfig(
    vocab_size=151936, hidden_size=2048, num_layers=28, num_heads=16,
    num_kv_heads=8, head_dim=128, intermediate_size=6144,
    act="silu", rope_theta=1e6, rms_eps=1e-6, qk_norm=True, tie_embeddings=True,
)

QWEN3_4B = TransformerConfig(
    vocab_size=151936, hidden_size=2560, num_layers=36, num_heads=32,
    num_kv_heads=8, head_dim=128, intermediate_size=9728,
    act="silu", rope_theta=1e6, rms_eps=1e-6, qk_norm=True, tie_embeddings=True,
)

GEMMA_2B = TransformerConfig(  # PaliGemma LLM (pi0/pi0.5 VLM)
    vocab_size=257152, hidden_size=2048, num_layers=18, num_heads=8,
    num_kv_heads=1, head_dim=256, intermediate_size=16384,
    act="gelu_tanh", rope_theta=10000.0, rms_eps=1e-6, norm_offset=1.0,
    embed_scale=True, tie_embeddings=True,
)

GEMMA_300M_EXPERT = TransformerConfig(  # pi0 action expert
    vocab_size=1, hidden_size=1024, num_layers=18, num_heads=8,
    num_kv_heads=1, head_dim=256, intermediate_size=4096,
    act="gelu_tanh", rope_theta=10000.0, rms_eps=1e-6, norm_offset=1.0,
    has_embed=False,
)

GEMMA_300M_EXPERT_ADARMS = dataclasses.replace(  # pi0.5 action expert
    GEMMA_300M_EXPERT, adarms_cond_dim=1024
)

QWEN3_06B_EXPERT = TransformerConfig(  # DM0-style action expert
    vocab_size=1, hidden_size=1024, num_layers=28, num_heads=16,
    num_kv_heads=8, head_dim=128, intermediate_size=3072,
    act="silu", rope_theta=1e6, rms_eps=1e-6, qk_norm=True, has_embed=False,
)


# --------------------------------------------------------------------------
# Tiny CI variants (shared attention geometry where MoT pairs them)
# --------------------------------------------------------------------------

LLM_TEST = TransformerConfig(
    vocab_size=512, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=16, intermediate_size=128, attn_impl="xla",
)
EXPERT_TEST = TransformerConfig(
    vocab_size=1, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=16, intermediate_size=64, has_embed=False, attn_impl="xla",
)
EXPERT_TEST_ADARMS = dataclasses.replace(EXPERT_TEST, adarms_cond_dim=32)
VIT_TEST = ViTConfig(
    image_size=28, patch_size=14, hidden_size=32, num_layers=2, num_heads=4,
    intermediate_size=64, select_layer=None,
)

LLM_PRESETS = {
    "llama2_7b": LLAMA2_7B,
    "qwen2_7b": QWEN2_7B,
    "qwen2_05b": QWEN2_05B,
    "qwen3_1.7b": QWEN3_1_7B,
    "qwen3_4b": QWEN3_4B,
    "gemma_2b": GEMMA_2B,
    "test": LLM_TEST,
}

EXPERT_PRESETS = {
    "gemma_300m": GEMMA_300M_EXPERT,
    "gemma_300m_adarms": GEMMA_300M_EXPERT_ADARMS,
    "qwen3_0.6b": QWEN3_06B_EXPERT,
    "test": EXPERT_TEST,
    "test_adarms": EXPERT_TEST_ADARMS,
}

VIT_PRESETS = {
    "clip_vit_l_336": CLIP_VIT_L_336,
    "siglip_so400m_384": SIGLIP_SO400M_384,
    "siglip_so400m_224": SIGLIP_SO400M_224,
    "test": VIT_TEST,
}
