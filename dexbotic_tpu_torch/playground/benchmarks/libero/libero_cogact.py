"""DB-CogACT on LIBERO (port of playground/benchmarks/libero/libero_cogact.py).

Usage:
    python -m dexbotic_tpu_torch.playground.benchmarks.libero.libero_cogact --task train
    python -m dexbotic_tpu_torch.playground.benchmarks.libero.libero_cogact --task inference
    python -m dexbotic_tpu_torch.playground.benchmarks.libero.libero_cogact --task inference_single
    python -m dexbotic_tpu_torch.playground.benchmarks.libero.libero_cogact --task compute_norm_stats
"""

from dataclasses import dataclass, field

from dexbotic_tpu_torch.exp import base_exp
from dexbotic_tpu_torch.exp.cogact_exp import CogActExp, CogActModelConfig
from dexbotic_tpu_torch.exp.optim import OptimizerConfig
from dexbotic_tpu_torch.exp.trainer import TrainerConfig


@dataclass
class LiberoCogActExp(CogActExp):
    exp_name: str = "libero_cogact"
    model: CogActModelConfig = field(
        default_factory=lambda: CogActModelConfig(
            llm_preset="llama2_7b", vit_preset="clip_vit_l_336",
            action_model_type="DiT-B", action_dim=7, chunk_size=16,
            freeze_mm_vision=True,
        )
    )
    data: base_exp.DataConfig = field(
        default_factory=lambda: base_exp.DataConfig(
            dataset_name="libero_goal+libero_10+libero_spatial+libero_object",
            image_processor="clip_336",
            aug_policy="v1",
        )
    )
    optimizer: OptimizerConfig = field(
        default_factory=lambda: OptimizerConfig(learning_rate=2e-5)
    )
    trainer: TrainerConfig = field(
        default_factory=lambda: TrainerConfig(
            output_dir="./output/libero_cogact", max_steps=20000,
            per_device_batch_size=8, gradient_accumulation_steps=2,
            save_steps=20000, gradient_checkpointing=True,
        )
    )


if __name__ == "__main__":
    LiberoCogActExp.main()
