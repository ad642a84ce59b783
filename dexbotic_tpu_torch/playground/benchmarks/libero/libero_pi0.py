"""DB-pi0 on LIBERO (port of playground/benchmarks/libero/libero_pi0.py).

    python -m dexbotic_tpu_torch.playground.benchmarks.libero.libero_pi0 --task train
"""

from dataclasses import dataclass, field

from dexbotic_tpu_torch.exp import base_exp
from dexbotic_tpu_torch.exp.pi0_exp import FlowModelConfig, Pi0Exp
from dexbotic_tpu_torch.exp.trainer import TrainerConfig


@dataclass
class LiberoPi0Exp(Pi0Exp):
    exp_name: str = "libero_pi0"
    model: FlowModelConfig = field(
        default_factory=lambda: FlowModelConfig(
            variant="pi0", llm_preset="gemma_2b", expert_preset="gemma_300m",
            vit_preset="siglip_so400m_224", action_dim=32, chunk_size=50,
        )
    )
    data: base_exp.DataConfig = field(
        default_factory=lambda: base_exp.DataConfig(
            dataset_name="libero_pi0_all",
            num_images=3,
            image_processor="siglip_224",
            image_pad_mode="zero",
            image_aspect_ratio=None,
            data_keys=["input_ids", "labels", "action", "image", "state", "image_masks"],
        )
    )
    trainer: TrainerConfig = field(
        default_factory=lambda: TrainerConfig(
            output_dir="./output/libero_pi0", max_steps=30000,
            per_device_batch_size=4, gradient_accumulation_steps=4,
            gradient_checkpointing=True,
        )
    )


if __name__ == "__main__":
    LiberoPi0Exp.main()
