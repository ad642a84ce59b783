"""DB-OFT on SimplerEnv (port of playground/benchmarks/simpler/simpler_oft.py):
the L1 head over 'simpler_all', CLIP-L/336 frames, 16 rows a device.

Usage:
    python -m dexbotic_tpu_torch.playground.benchmarks.simpler.simpler_oft --task train
    python -m dexbotic_tpu_torch.playground.benchmarks.simpler.simpler_oft --task inference
"""

from dataclasses import dataclass, field

from dexbotic_tpu_torch.exp import base_exp
from dexbotic_tpu_torch.exp.oft_exp import OFTExp, OFTModelConfig
from dexbotic_tpu_torch.exp.trainer import TrainerConfig


@dataclass
class SimplerOFTExp(OFTExp):
    exp_name: str = "simpler_oft"
    model: OFTModelConfig = field(
        default_factory=lambda: OFTModelConfig(action_model_type="L1")
    )
    data: base_exp.DataConfig = field(
        default_factory=lambda: base_exp.DataConfig(
            dataset_name="simpler_all", image_processor="clip_336",
        )
    )
    trainer: TrainerConfig = field(
        default_factory=lambda: TrainerConfig(
            output_dir="./output/simpler_oft", max_steps=30000,
            per_device_batch_size=16, save_total_limit=2,
        )
    )


if __name__ == "__main__":
    SimplerOFTExp.main()
