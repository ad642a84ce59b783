"""Hybrid CogACT co-training (port of dexbotic_tpu/exp/hybrid_cogact_exp.py).

The joint loss is the causal-LM text loss plus the diffusion action loss,
gated by per-sample ``has_text`` / ``has_action`` flags, so that action-only
robot data and VQA-style text data mix in one batch
(``models/cogact.cogact_loss(with_text_loss=True)``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from dexbotic_tpu_torch.data import transforms as T
from dexbotic_tpu_torch.data.multimodal import LoadMultiModal
from dexbotic_tpu_torch.exp import base_exp
from dexbotic_tpu_torch.exp.cogact_exp import CogActExp
from dexbotic_tpu_torch.models.cogact import cogact_loss


@dataclass
class HybridActionConfig(base_exp.ActionConfig):
    """Adds the AddActionFlag / AddTextFlag transforms, so that mixed batches
    carry the gating flags."""

    empty_action_dim: int = 112  # chunk * action_dim: a text row's action placeholder

    def build_action_process_func(self) -> T.Pipeline:
        """The reference's order: actions are not turned into answer strings
        (add_answer=False), ReplaceAnswer marks answer-less (robot) rows
        has_text=0, and the flag transforms run on the selected frame's dict,
        whose empty-action placeholder is the per-frame [chunk * dim] vector."""
        stats = self._read_norm_stats(self.statistic_mapping)
        return T.Pipeline([
            T.ToDict(),
            T.ToNumpy(),
            T.AddAction(predict_length=1),
            T.DeltaAction(enable=self.delta),
            T.AddTrajectory(trajectory_length=self.trajectory_length,
                            padding_mode=self.trajectory_padding_mode,
                            padding_action=self.padding_action),
            T.ActionNormAnd2String(statistic_mapping=stats, vocab_size=self.vocab_size,
                                   string_format=self.string_format, add_answer=False),
            LoadMultiModal(),
            T.AddPromptTemplate(prompt_template=self.prompt_template),
            T.ReplaceAnswer(default_answer=self.replace_with_default_answer),
            T.ToConversation(),
            T.ToList(select_frame=True),
            T.AddActionFlag(np.zeros((self.empty_action_dim,), np.float32)),
            T.AddTextFlag(),
        ])


@dataclass
class HybridCogActExp(CogActExp):
    exp_name: str = "hybrid_cogact"
    action: HybridActionConfig = field(default_factory=HybridActionConfig)
    data: base_exp.DataConfig = field(default_factory=lambda: base_exp.DataConfig(
        data_keys=["input_ids", "labels", "action", "image", "has_action", "has_text"]))

    def build_model(self, tokenizer):
        cfg, model, _ = super().build_model(tokenizer)
        remat = self.trainer.gradient_checkpointing

        def loss_fn(model, batch, generator):
            return cogact_loss(model, cfg, batch, generator, remat=remat, with_text_loss=True)

        return cfg, model, loss_fn


if __name__ == "__main__":
    HybridCogActExp.main()
