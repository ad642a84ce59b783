"""DB-CogACT on ManiSkill2 (port of playground/benchmarks/maniskill2/maniskill2_cogact.py):
the five pick/stack task suites joined with '+', CLIP-L/336 frames, 16
rows a device.

Usage:
    python -m dexbotic_tpu_torch.playground.benchmarks.maniskill2.maniskill2_cogact --task train
    python -m dexbotic_tpu_torch.playground.benchmarks.maniskill2.maniskill2_cogact --task inference
"""

from dataclasses import dataclass, field

from dexbotic_tpu_torch.exp import base_exp
from dexbotic_tpu_torch.exp.cogact_exp import CogActExp, CogActModelConfig
from dexbotic_tpu_torch.exp.trainer import TrainerConfig

MANISKILL_SUITES = (
    "maniskill_pickcube+maniskill_stackcube+maniskill_picksingleycb"
    "+maniskill_picksingleegad+maniskill_pickclutterycb"
)


@dataclass
class ManiskillCogActExp(CogActExp):
    exp_name: str = "maniskill2_cogact"
    model: CogActModelConfig = field(default_factory=CogActModelConfig)
    data: base_exp.DataConfig = field(
        default_factory=lambda: base_exp.DataConfig(
            dataset_name=MANISKILL_SUITES, image_processor="clip_336",
        )
    )
    trainer: TrainerConfig = field(
        default_factory=lambda: TrainerConfig(
            output_dir="./output/maniskill2_cogact", max_steps=30000,
            per_device_batch_size=16, save_total_limit=2,
        )
    )


if __name__ == "__main__":
    ManiskillCogActExp.main()
