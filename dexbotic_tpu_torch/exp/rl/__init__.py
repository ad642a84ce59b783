"""GRPO post-training (port of dexbotic_tpu/exp/rl)."""
