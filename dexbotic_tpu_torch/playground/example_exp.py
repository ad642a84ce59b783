"""Example: fine-tune a CogACT policy on a custom Dexdata directory (port of
playground/example_exp.py), the user contract: register the data under a
name, subclass the exp's config dataclasses, override the fields that
differ, dispatch on ``--task``.

The data config keeps DataConfig's default ``siglip_224`` processor, as the
JAX example does, although CogActModelConfig's CLIP-L/336 tower takes 336-
pixel frames: set ``image_processor="clip_336"`` to train it.

    python -m dexbotic_tpu_torch.playground.example_exp \
        --task {train,inference,inference_single,compute_norm_stats}
"""

from dataclasses import dataclass, field

from dexbotic_tpu_torch.data.registry import register_dataset
from dexbotic_tpu_torch.exp import base_exp
from dexbotic_tpu_torch.exp.cogact_exp import CogActExp, CogActModelConfig
from dexbotic_tpu_torch.exp.optim import OptimizerConfig
from dexbotic_tpu_torch.exp.trainer import TrainerConfig

# 1. register your Dexdata directory under a name
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


# 2. subclass the exp and override what differs
@dataclass
class MyExp(CogActExp):
    exp_name: str = "my_exp"
    model: CogActModelConfig = field(
        default_factory=lambda: CogActModelConfig(
            llm_preset="qwen2_7b", action_dim=7, chunk_size=16,
        )
    )
    data: base_exp.DataConfig = field(
        default_factory=lambda: base_exp.DataConfig(dataset_name="custom_demo")
    )
    optimizer: OptimizerConfig = field(
        default_factory=lambda: OptimizerConfig(
            learning_rate=2e-5, mm_projector_lr=2e-5, action_head_lr=1e-4
        )
    )
    trainer: TrainerConfig = field(
        default_factory=lambda: TrainerConfig(
            output_dir="./output/my_exp", max_steps=10000,
        )
    )


# 3. dispatch on --task
if __name__ == "__main__":
    MyExp.main()
