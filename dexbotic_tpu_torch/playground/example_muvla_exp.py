"""Example: train DB-MUVLA (the map-understanding VLA) on custom data
(port of playground/example_muvla_exp.py).

MUVLA batches carry a MAP view, observation views and an optional
per-sample reward; the loss is the reward-weighted CE plus the expectile
reward regression, and inference is autoregressive text over the fused
map and observation tokens.  Register your suite under ``./data/my_nav``
and run:

    python -m dexbotic_tpu_torch.playground.example_muvla_exp --task train
"""

from dataclasses import dataclass, field

from dexbotic_tpu_torch.data.registry import register_dataset
from dexbotic_tpu_torch.exp import base_exp
from dexbotic_tpu_torch.exp.muvla_exp import MUVLAExp, MUVLAModelConfig
from dexbotic_tpu_torch.exp.trainer import TrainerConfig

register_dataset(
    {
        "demo": {
            "data_path_prefix": "./data/my_nav/video",
            "annotations": "./data/my_nav",
            "frequency": 1,
        }
    },
    prefix="custom_map",
    meta_data={},
)


@dataclass
class MyMUVLAExp(MUVLAExp):
    exp_name: str = "my_muvla"
    model: MUVLAModelConfig = field(
        default_factory=lambda: MUVLAModelConfig(inter_dim=1024, num_history_queries=192))
    data: base_exp.DataConfig = field(
        default_factory=lambda: base_exp.DataConfig(
            dataset_name="custom_map_demo", image_processor="clip_336",
            data_keys=["input_ids", "labels", "image", "reward"]))
    trainer: TrainerConfig = field(
        default_factory=lambda: TrainerConfig(output_dir="./output/my_muvla", max_steps=10000,
                                              per_device_batch_size=8))


if __name__ == "__main__":
    MyMUVLAExp.main()
