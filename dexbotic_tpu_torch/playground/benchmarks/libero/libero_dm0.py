"""DB-DM0 on LIBERO (port of playground/benchmarks/libero/libero_dm0.py:
libero_pi0_all data, 3 views, trajectory 50 with 'last' padding, the Qwen3
backbone pair).  The action config is the JAX recipe's: a fresh
``Pi0ActionConfig``, as in ``libero_pi05``.

    python -m dexbotic_tpu_torch.playground.benchmarks.libero.libero_dm0 --task train
"""

from dataclasses import dataclass, field

from dexbotic_tpu_torch.exp import base_exp
from dexbotic_tpu_torch.exp.pi0_exp import DM0Exp, FlowModelConfig, Pi0ActionConfig
from dexbotic_tpu_torch.exp.trainer import TrainerConfig


@dataclass
class LiberoDM0Exp(DM0Exp):
    exp_name: str = "libero_dm0"
    model: FlowModelConfig = field(
        default_factory=lambda: FlowModelConfig(
            variant="dm0", llm_preset="qwen3_1.7b", expert_preset="qwen3_0.6b",
            vit_preset="siglip_so400m_224", action_dim=7, chunk_size=50,
        )
    )
    action: Pi0ActionConfig = field(
        default_factory=lambda: Pi0ActionConfig(
            trajectory_length=50, trajectory_padding_mode="last", delta=True,
        )
    )
    data: base_exp.DataConfig = field(
        default_factory=lambda: base_exp.DataConfig(
            dataset_name="libero_pi0_all", num_images=3,
            image_processor="siglip_224", image_pad_mode="zero",
            image_aspect_ratio=None,
            data_keys=["input_ids", "labels", "action", "image", "state", "image_masks"],
        )
    )
    trainer: TrainerConfig = field(
        default_factory=lambda: TrainerConfig(
            output_dir="./output/libero_dm0", max_steps=30000,
            per_device_batch_size=4, gradient_accumulation_steps=4,
            gradient_checkpointing=True,
        )
    )


if __name__ == "__main__":
    LiberoDM0Exp.main()
