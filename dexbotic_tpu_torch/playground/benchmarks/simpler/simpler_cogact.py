"""DB-CogACT on SimplerEnv (port of playground/benchmarks/simpler/simpler_cogact.py):
'simpler_all' data, CLIP-L/336 frames, 16 rows a device.

Usage:
    python -m dexbotic_tpu_torch.playground.benchmarks.simpler.simpler_cogact --task train
    python -m dexbotic_tpu_torch.playground.benchmarks.simpler.simpler_cogact --task inference
"""

from dataclasses import dataclass, field

from dexbotic_tpu_torch.exp import base_exp
from dexbotic_tpu_torch.exp.cogact_exp import CogActExp, CogActModelConfig
from dexbotic_tpu_torch.exp.trainer import TrainerConfig


@dataclass
class SimplerCogActExp(CogActExp):
    exp_name: str = "simpler_cogact"
    model: CogActModelConfig = field(default_factory=CogActModelConfig)
    data: base_exp.DataConfig = field(
        default_factory=lambda: base_exp.DataConfig(
            dataset_name="simpler_all", image_processor="clip_336",
        )
    )
    trainer: TrainerConfig = field(
        default_factory=lambda: TrainerConfig(
            output_dir="./output/simpler_cogact", max_steps=30000,
            per_device_batch_size=16, save_total_limit=2,
        )
    )


if __name__ == "__main__":
    SimplerCogActExp.main()
