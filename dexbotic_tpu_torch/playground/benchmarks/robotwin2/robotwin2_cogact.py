"""DB-CogACT on RoboTwin2.0 (port of playground/benchmarks/robotwin2/robotwin2_cogact.py):
14-dof dual-arm actions in chunks of 16, CLIP-L/336 frames.

Usage:
    python -m dexbotic_tpu_torch.playground.benchmarks.robotwin2.robotwin2_cogact --task train
    python -m dexbotic_tpu_torch.playground.benchmarks.robotwin2.robotwin2_cogact --task inference
"""

from dataclasses import dataclass, field

from dexbotic_tpu_torch.exp import base_exp
from dexbotic_tpu_torch.exp.cogact_exp import CogActExp, CogActModelConfig


@dataclass
class RoboTwin2CogActExp(CogActExp):
    exp_name: str = "robotwin2_cogact"
    model: CogActModelConfig = field(
        default_factory=lambda: CogActModelConfig(action_dim=14, chunk_size=16)
    )
    data: base_exp.DataConfig = field(
        default_factory=lambda: base_exp.DataConfig(
            dataset_name="robotwin2_all", image_processor="clip_336",
        )
    )


if __name__ == "__main__":
    RoboTwin2CogActExp.main()
