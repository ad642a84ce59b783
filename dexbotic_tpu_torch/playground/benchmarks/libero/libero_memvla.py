"""DB-MemVLA on LIBERO (port of playground/benchmarks/libero/libero_memvla.py):
DiT-B with memory cross-attention, chunk 16, per tokens of 256 channels, a
bank of 16 entries consolidated by ToMe, CLIP-L/336 frames, trained on
episode-ordered 'parallel_stream' batches (a bank a row, carried from step
to step).  ``--task inference`` serves it through MemVLAServer, with
``episode_first_frame`` on each request.

Usage:
    python -m dexbotic_tpu_torch.playground.benchmarks.libero.libero_memvla --task train
    python -m dexbotic_tpu_torch.playground.benchmarks.libero.libero_memvla --task inference
"""

from dataclasses import dataclass, field

from dexbotic_tpu_torch.exp import base_exp
from dexbotic_tpu_torch.exp.memvla_exp import MemVLAExp, MemVLAModelConfig
from dexbotic_tpu_torch.exp.trainer import TrainerConfig


@dataclass
class LiberoMemVLAExp(MemVLAExp):
    exp_name: str = "libero_memvla"
    model: MemVLAModelConfig = field(
        default_factory=lambda: MemVLAModelConfig(
            action_model_type="DiT-B", action_dim=7, chunk_size=16,
            per_token_size=256, mem_length=16, consolidate_type="tome",
            dataloader_type="parallel_stream",
        )
    )
    data: base_exp.DataConfig = field(
        default_factory=lambda: base_exp.DataConfig(
            dataset_name="libero_goal+libero_10+libero_spatial+libero_object",
            image_processor="clip_336",
        )
    )
    trainer: TrainerConfig = field(
        default_factory=lambda: TrainerConfig(
            output_dir="./output/libero_memvla", max_steps=20000,
            gradient_checkpointing=True,
        )
    )


if __name__ == "__main__":
    LiberoMemVLAExp.main()
