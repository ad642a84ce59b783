"""DB-OFT on LIBERO (port of playground/benchmarks/libero/libero_oft.py):
the L1 head, chunk 8, an 8-dim proprio token.

Usage:
    python -m dexbotic_tpu_torch.playground.benchmarks.libero.libero_oft --task train
    python -m dexbotic_tpu_torch.playground.benchmarks.libero.libero_oft --task inference
"""

from dataclasses import dataclass, field

from dexbotic_tpu_torch.exp import base_exp
from dexbotic_tpu_torch.exp.oft_exp import OFTExp, OFTModelConfig
from dexbotic_tpu_torch.exp.trainer import TrainerConfig


@dataclass
class LiberoOFTExp(OFTExp):
    exp_name: str = "libero_oft"
    model: OFTModelConfig = field(
        default_factory=lambda: OFTModelConfig(
            action_model_type="L1", action_dim=7, chunk_size=8,
            use_proprio=True, proprio_dim=8,
        )
    )
    data: base_exp.DataConfig = field(
        default_factory=lambda: base_exp.DataConfig(
            dataset_name="libero_oft_all", image_processor="clip_336",
            data_keys=["input_ids", "labels", "action", "image", "state"],
        )
    )
    trainer: TrainerConfig = field(
        default_factory=lambda: TrainerConfig(
            output_dir="./output/libero_oft", max_steps=40000,
            gradient_checkpointing=True,
        )
    )


if __name__ == "__main__":
    LiberoOFTExp.main()
