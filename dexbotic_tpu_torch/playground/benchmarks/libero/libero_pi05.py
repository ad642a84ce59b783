"""DB-pi0.5 on LIBERO (port of playground/benchmarks/libero/libero_pi05.py:
libero_pi0_all data, 3 views, trajectory 10 with 'last' padding, the adaRMS
action expert, model_max_length 200).  The action config is the JAX recipe's:
a fresh ``Pi0ActionConfig``, so mean/std normalisation, no image masks and
the default prompt template, where ``Pi05Exp`` itself sets quantiles, masks
and "{prompt}".

    python -m dexbotic_tpu_torch.playground.benchmarks.libero.libero_pi05 --task train
"""

from dataclasses import dataclass, field

from dexbotic_tpu_torch.exp import base_exp
from dexbotic_tpu_torch.exp.pi0_exp import FlowModelConfig, Pi0ActionConfig, Pi05Exp
from dexbotic_tpu_torch.exp.trainer import TrainerConfig


@dataclass
class LiberoPi05Exp(Pi05Exp):
    exp_name: str = "libero_pi05"
    model: FlowModelConfig = field(
        default_factory=lambda: FlowModelConfig(
            variant="pi05", llm_preset="gemma_2b", expert_preset="gemma_300m_adarms",
            vit_preset="siglip_so400m_224", action_dim=32, chunk_size=10,
        )
    )
    action: Pi0ActionConfig = field(
        default_factory=lambda: Pi0ActionConfig(
            trajectory_length=10, trajectory_padding_mode="last", delta=False,
        )
    )
    tokenizer: base_exp.TokenizerConfig = field(
        default_factory=lambda: base_exp.TokenizerConfig(model_max_length=200)
    )
    data: base_exp.DataConfig = field(
        default_factory=lambda: base_exp.DataConfig(
            dataset_name="libero_pi0_all", num_images=3,
            image_processor="siglip_224", image_pad_mode="zero",
            image_aspect_ratio=None,
            data_keys=["input_ids", "labels", "action", "image", "state", "image_masks"],
        )
    )
    trainer: TrainerConfig = field(
        default_factory=lambda: TrainerConfig(
            output_dir="./output/libero_pi05", max_steps=30000,
            per_device_batch_size=4, gradient_accumulation_steps=4,
            gradient_checkpointing=True,
        )
    )


if __name__ == "__main__":
    LiberoPi05Exp.main()
