"""DB-OFT on ManiSkill2 (port of playground/benchmarks/maniskill2/maniskill2_oft.py):
the L1 head with a 9-dim proprio token over the five task suites,
CLIP-L/336 frames, 16 rows a device.

Usage:
    python -m dexbotic_tpu_torch.playground.benchmarks.maniskill2.maniskill2_oft --task train
    python -m dexbotic_tpu_torch.playground.benchmarks.maniskill2.maniskill2_oft --task inference
"""

from dataclasses import dataclass, field

from dexbotic_tpu_torch.exp import base_exp
from dexbotic_tpu_torch.exp.oft_exp import OFTExp, OFTModelConfig
from dexbotic_tpu_torch.exp.trainer import TrainerConfig

MANISKILL_SUITES = (
    "maniskill_pickcube+maniskill_stackcube+maniskill_picksingleycb"
    "+maniskill_picksingleegad+maniskill_pickclutterycb"
)


@dataclass
class ManiskillOFTExp(OFTExp):
    exp_name: str = "maniskill2_oft"
    model: OFTModelConfig = field(
        default_factory=lambda: OFTModelConfig(
            action_model_type="L1", use_proprio=True, proprio_dim=9,
        )
    )
    data: base_exp.DataConfig = field(
        default_factory=lambda: base_exp.DataConfig(
            dataset_name=MANISKILL_SUITES, image_processor="clip_336",
            data_keys=["input_ids", "labels", "action", "image", "state"],
        )
    )
    trainer: TrainerConfig = field(
        default_factory=lambda: TrainerConfig(
            output_dir="./output/maniskill2_oft", max_steps=30000,
            per_device_batch_size=16, save_total_limit=2,
        )
    )


if __name__ == "__main__":
    ManiskillOFTExp.main()
