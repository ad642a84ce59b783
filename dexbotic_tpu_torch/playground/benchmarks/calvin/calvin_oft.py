"""DB-OFT on CALVIN ABC-D (port of playground/benchmarks/calvin/calvin_oft.py):
the L1 head, chunks of 8, CLIP-L/336 frames.

Usage:
    python -m dexbotic_tpu_torch.playground.benchmarks.calvin.calvin_oft --task train
    python -m dexbotic_tpu_torch.playground.benchmarks.calvin.calvin_oft --task inference
"""

from dataclasses import dataclass, field

from dexbotic_tpu_torch.exp import base_exp
from dexbotic_tpu_torch.exp.oft_exp import OFTExp, OFTModelConfig


@dataclass
class CalvinOFTExp(OFTExp):
    exp_name: str = "calvin_oft"
    model: OFTModelConfig = field(
        default_factory=lambda: OFTModelConfig(action_model_type="L1", chunk_size=8)
    )
    data: base_exp.DataConfig = field(
        default_factory=lambda: base_exp.DataConfig(
            dataset_name="calvin_abc", image_processor="clip_336",
        )
    )


if __name__ == "__main__":
    CalvinOFTExp.main()
