"""Example: train DB-NaVILA (the video-frame navigation VLA) on custom data
(port of playground/example_navila_exp.py).

A sample is the current frame plus a uniformly sampled frame history;
training is length-grouped and packed (use_packing).  Register your suite
under ``./data/my_nav`` and run:

    python -m dexbotic_tpu_torch.playground.example_navila_exp --task train

NaVILAExp has no ``--task inference``: serve with ``exp/serve.NaVILAServer``
built by hand.
"""

from dataclasses import dataclass, field

from dexbotic_tpu_torch.data.registry import register_dataset
from dexbotic_tpu_torch.exp import base_exp
from dexbotic_tpu_torch.exp.navila_exp import NaVILADataConfig, NaVILAExp, NaVILAModelConfig
from dexbotic_tpu_torch.exp.trainer import TrainerConfig

register_dataset(
    {
        "demo": {
            "data_path_prefix": "./data/my_nav/videos",
            "annotations": "./data/my_nav",
            "frequency": 1,
        }
    },
    prefix="custom_nav",
    meta_data={},
)


@dataclass
class MyNaVILAExp(NaVILAExp):
    exp_name: str = "my_navila"
    model: NaVILAModelConfig = field(
        default_factory=lambda: NaVILAModelConfig(num_video_frames=8, use_packing=True)
    )
    data: NaVILADataConfig = field(
        default_factory=lambda: NaVILADataConfig(
            dataset_name="custom_nav_demo", image_processor="siglip_384", num_video_frames=8,
        )
    )
    tokenizer: base_exp.TokenizerConfig = field(
        default_factory=lambda: base_exp.TokenizerConfig(model_max_length=4096,
                                                         chat_template="llama_3")
    )
    trainer: TrainerConfig = field(
        default_factory=lambda: TrainerConfig(output_dir="./output/my_navila", max_steps=10000,
                                              per_device_batch_size=4)
    )


if __name__ == "__main__":
    MyNaVILAExp.main()
