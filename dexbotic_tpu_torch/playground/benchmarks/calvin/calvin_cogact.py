"""DB-CogACT on CALVIN ABC-D (port of playground/benchmarks/calvin/calvin_cogact.py):
DiT-B, 7-dof actions in chunks of 16, CLIP-L/336 frames, remat.  CALVIN's
euler angles are periodic: the registry's meta data wraps them in
DeltaAction.

Usage:
    python -m dexbotic_tpu_torch.playground.benchmarks.calvin.calvin_cogact --task train
    python -m dexbotic_tpu_torch.playground.benchmarks.calvin.calvin_cogact --task inference
"""

from dataclasses import dataclass, field

from dexbotic_tpu_torch.exp import base_exp
from dexbotic_tpu_torch.exp.cogact_exp import CogActExp, CogActModelConfig
from dexbotic_tpu_torch.exp.trainer import TrainerConfig


@dataclass
class CalvinCogActExp(CogActExp):
    exp_name: str = "calvin_cogact"
    model: CogActModelConfig = field(
        default_factory=lambda: CogActModelConfig(
            action_model_type="DiT-B", action_dim=7, chunk_size=16,
        )
    )
    data: base_exp.DataConfig = field(
        default_factory=lambda: base_exp.DataConfig(
            dataset_name="calvin_abc", image_processor="clip_336",
        )
    )
    trainer: TrainerConfig = field(
        default_factory=lambda: TrainerConfig(
            output_dir="./output/calvin_cogact", max_steps=40000,
            gradient_checkpointing=True,
        )
    )


if __name__ == "__main__":
    CalvinCogActExp.main()
