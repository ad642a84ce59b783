"""DB-OFT-Discrete on LIBERO (port of playground/benchmarks/libero/
libero_oft_discrete.py): libero_goal, chunk 8, 256 bins, parallel decode;
the SimpleVLA-RL actor's SFT stage.

Usage:
    python -m dexbotic_tpu_torch.playground.benchmarks.libero.libero_oft_discrete --task train
    python -m dexbotic_tpu_torch.playground.benchmarks.libero.libero_oft_discrete --task inference
"""

from dataclasses import dataclass, field

from dexbotic_tpu_torch.exp import base_exp
from dexbotic_tpu_torch.exp.oft_exp import OFTDiscreteExp, OFTModelConfig
from dexbotic_tpu_torch.exp.trainer import TrainerConfig


@dataclass
class LiberoOFTDiscreteExp(OFTDiscreteExp):
    exp_name: str = "libero_oft_discrete"
    model: OFTModelConfig = field(
        default_factory=lambda: OFTModelConfig(
            action_model_type="Discrete", action_dim=7, chunk_size=8,
            num_bins=256, use_proprio=False,
        )
    )
    action: base_exp.ActionConfig = field(
        default_factory=lambda: base_exp.ActionConfig(trajectory_length=8)
    )
    data: base_exp.DataConfig = field(
        default_factory=lambda: base_exp.DataConfig(
            dataset_name="libero_goal", image_processor="clip_336",
        )
    )
    trainer: TrainerConfig = field(
        default_factory=lambda: TrainerConfig(
            output_dir="./output/libero_oft_discrete", max_steps=25000,
            per_device_batch_size=16, save_total_limit=2,
        )
    )


if __name__ == "__main__":
    LiberoOFTDiscreteExp.main()
