"""DB-MemVLA on SimplerEnv (port of playground/benchmarks/simpler/simpler_memvla.py):
MemVLAExp's model over 'simpler_bridge', CLIP-L/336 frames.  ``--task
inference`` serves it through MemVLAServer, with ``episode_first_frame``
on each request.

Usage:
    python -m dexbotic_tpu_torch.playground.benchmarks.simpler.simpler_memvla --task train
    python -m dexbotic_tpu_torch.playground.benchmarks.simpler.simpler_memvla --task inference
"""

from dataclasses import dataclass, field

from dexbotic_tpu_torch.exp import base_exp
from dexbotic_tpu_torch.exp.memvla_exp import MemVLAExp, MemVLAModelConfig


@dataclass
class SimplerMemVLAExp(MemVLAExp):
    exp_name: str = "simpler_memvla"
    model: MemVLAModelConfig = field(default_factory=MemVLAModelConfig)
    data: base_exp.DataConfig = field(
        default_factory=lambda: base_exp.DataConfig(
            dataset_name="simpler_bridge", image_processor="clip_336",
        )
    )


if __name__ == "__main__":
    SimplerMemVLAExp.main()
