"""Example: fine-tune DB-MemVLA on a custom Dexdata directory (port of
playground/example_memvla_exp.py).

MemVLA trains episode-ordered: pick a ``dataloader_type`` ('stream' |
'group' | 'parallel_stream') and the memory bank's geometry; the rest is
the usual subclass-and-override contract.

    python -m dexbotic_tpu_torch.playground.example_memvla_exp --task train
"""

from dataclasses import dataclass, field

from dexbotic_tpu_torch.data.registry import register_dataset
from dexbotic_tpu_torch.exp import base_exp
from dexbotic_tpu_torch.exp.memvla_exp import MemVLAExp, MemVLAModelConfig
from dexbotic_tpu_torch.exp.trainer import TrainerConfig

register_dataset(
    {
        "demo": {
            "data_path_prefix": "./data/my_robot/video",
            "annotations": "./data/my_robot",
            "frequency": 1,
        }
    },
    prefix="custom",
    meta_data={"non_delta_mask": [6], "periodic_mask": None, "periodic_range": None},
)


@dataclass
class MyMemVLAExp(MemVLAExp):
    exp_name: str = "my_memvla"
    model: MemVLAModelConfig = field(
        default_factory=lambda: MemVLAModelConfig(
            dataloader_type="stream",  # in-episode frame order preserved
            mem_length=16,
            per_token_size=256,
        )
    )
    data: base_exp.DataConfig = field(
        default_factory=lambda: base_exp.DataConfig(
            dataset_name="custom_demo", image_processor="clip_336",
        )
    )
    trainer: TrainerConfig = field(
        default_factory=lambda: TrainerConfig(
            output_dir="./output/my_memvla", max_steps=10000,
            per_device_batch_size=8,
        )
    )


if __name__ == "__main__":
    MyMemVLAExp.main()
