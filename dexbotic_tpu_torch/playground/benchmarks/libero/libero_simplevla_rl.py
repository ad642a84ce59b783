"""SimpleVLA-RL (GRPO) post-training of OFT-Discrete on LIBERO (port of
playground/benchmarks/libero/libero_simplevla_rl.py): LIBERO spatial, 16
envs, 512 steps, chunk 8, action_dim 7.  The frames are preprocessed for
CLIP-L/336, the actor's tower (the JAX recipe keeps DataConfig's default
siglip_224 processor, whose 224-pixel frames CLIP-L/336's position table
does not take).

Usage:
    python -m dexbotic_tpu_torch.playground.benchmarks.libero.libero_simplevla_rl
"""

from dataclasses import dataclass, field

from dexbotic_tpu_torch.exp import base_exp
from dexbotic_tpu_torch.exp.oft_exp import OFTModelConfig
from dexbotic_tpu_torch.exp.simplevla_rl_exp import RLEnvConfig, SimpleVLARLExp


@dataclass
class LiberoSimpleVLARLExp(SimpleVLARLExp):
    exp_name: str = "libero_simplevla_rl"
    model: OFTModelConfig = field(
        default_factory=lambda: OFTModelConfig(
            action_model_type="Discrete", action_dim=7, chunk_size=8,
        )
    )
    env: RLEnvConfig = field(
        default_factory=lambda: RLEnvConfig(
            env_type="libero", task_suite_name="libero_spatial", num_envs=16,
            max_episode_steps=512,
        )
    )
    data: base_exp.DataConfig = field(
        default_factory=lambda: base_exp.DataConfig(image_processor="clip_336"))


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--task", default="train")
    p.parse_known_args()
    LiberoSimpleVLARLExp().train_rl()
