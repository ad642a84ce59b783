"""DB-pi0 on ManiSkill2 (port of playground/benchmarks/maniskill2/maniskill2_pi0.py):
Pi0Exp's model over 'maniskill2_all', 3 SigLIP/224 views with zero padding
and image masks, the state as an input.

Usage:
    python -m dexbotic_tpu_torch.playground.benchmarks.maniskill2.maniskill2_pi0 --task train
    python -m dexbotic_tpu_torch.playground.benchmarks.maniskill2.maniskill2_pi0 --task inference
"""

from dataclasses import dataclass, field

from dexbotic_tpu_torch.exp import base_exp
from dexbotic_tpu_torch.exp.pi0_exp import Pi0Exp


@dataclass
class Maniskill2Pi0Exp(Pi0Exp):
    exp_name: str = "maniskill2_pi0"
    data: base_exp.DataConfig = field(
        default_factory=lambda: base_exp.DataConfig(
            dataset_name="maniskill2_all", num_images=3,
            image_processor="siglip_224", image_pad_mode="zero",
            image_aspect_ratio=None,
            data_keys=["input_ids", "labels", "action", "image", "state", "image_masks"],
        )
    )


if __name__ == "__main__":
    Maniskill2Pi0Exp.main()
