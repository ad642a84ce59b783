"""NaVILA experiment (port of dexbotic_tpu/exp/navila_exp.py): the video-frame
navigation VLA, trained on packed rows and served over an 8-frame history.

Defaults as the JAX package's: LLaMA-2-7B + SigLIP-so400m/384 +
``mlp_downsample`` (196 tokens a frame), 8 frames, the llama_3 chat template
with 4096-token rows, NaVILA's soft CE over the digit tokens.  ``train``
groups samples of similar lengths (``exp/mem_trainer.length_grouped_batches``)
and packs ``samples_per_pack`` of them into ``per_device_batch_size`` rows of
``pack_max_len`` tokens (``models/navila.pack_batch``) with segment-isolated
attention.  Serving is :class:`NaVILAInferenceSession` behind
``exp/serve.NaVILAServer``; as in the JAX package the exp has no
``inference()`` (the server is built by hand), and there is no converter of
a released NaVILA checkpoint.  A fleet of sessions (one a robot) may share
one continuous-batching decode engine (:meth:`NaVILAInferenceSession.make_shared_engine`).
Packed training runs over the data axis of a mesh (each data rank packs
its own share of the length-grouped samples).  Not ported: context
parallelism (``context_parallel_seq > 1``, ROADMAP Queue 1 item 11b).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from dexbotic_tpu_torch.exp import base_exp
from dexbotic_tpu_torch.exp.mem_trainer import length_grouped_batches
from dexbotic_tpu_torch.models import presets
from dexbotic_tpu_torch.models.generate import generate
from dexbotic_tpu_torch.models.navila import (
    FrameHistoryBuffer,
    NaVILAConfig,
    build_navila,
    navila_loss,
    navila_packed_loss,
    pack_batch,
)
from dexbotic_tpu_torch.models.vlm import VLMConfig
from dexbotic_tpu_torch.tokenization import conversation as conversation_lib

NAV_PROMPT = (
    "Imagine you are a robot programmed for navigation tasks. You have been given a "
    "video of historical observations and an image of the current observation "
    "<image>. Your assigned task is: {prompt} Analyze this series of images to "
    "decide your next move, which could involve turning left or right by a specific "
    "degree, moving forward a certain distance, or stopping if the task is completed."
)


def nav_question(instruction: str, n_frames: int) -> str:
    """The served navigation question, byte for byte the reference's: one
    '<image>\\n' tag a history frame, then the current observation's."""
    interleaved = "<image>\n" * (n_frames - 1)
    return (
        "Imagine you are a robot programmed for navigation tasks. You have been given a video "
        f'of historical observations {interleaved}, and current observation <image>\n. Your assigned task is: "{instruction}" '
        "Analyze this series of images to decide your next action, which could be turning left or right by a specific "
        "degree, moving forward a certain distance, or stop if the task is completed."
    )


def _no_release_converter(*args, **kwargs):
    raise ValueError("there is no converter of a released NaVILA checkpoint (nor in the JAX "
                     "package): model_name_or_path must be a checkpoint-{step} directory")


@dataclass
class NaVILAModelConfig(base_exp.Config):
    model_name_or_path: Optional[str] = None  # a checkpoint-{step} directory
    llm_preset: str = "llama2_7b"
    vit_preset: str = "siglip_so400m_384"
    mm_projector_type: str = "mlp_downsample"
    num_video_frames: int = 8
    soft_ce_std: float = 1.0
    use_soft_ce: bool = True
    seed: int = 0
    use_packing: bool = True
    pack_max_len: int = 0  # 0 -> tokenizer.model_max_length
    samples_per_pack: int = 0  # 0 -> 2x the packed rows
    context_parallel_seq: int = 1  # > 1 raises: ROADMAP Queue 1 item 11b

    def build_config(self) -> NaVILAConfig:
        if self.context_parallel_seq > 1:
            raise NotImplementedError("context parallelism (context_parallel_seq > 1: ring "
                                      "attention over a 'seq' mesh axis) is not ported yet: "
                                      "ROADMAP Queue 1 item 11b")
        return NaVILAConfig(
            vlm=VLMConfig(llm=presets.LLM_PRESETS[self.llm_preset],
                          vit=presets.VIT_PRESETS[self.vit_preset],
                          projector_type=self.mm_projector_type),
            num_video_frames=self.num_video_frames, soft_ce_std=self.soft_ce_std,
            use_soft_ce=self.use_soft_ce)

    @torch.no_grad()
    def build_params(self, cfg: NaVILAConfig, device, prepare=None):
        model = build_navila(cfg, device, seed=self.seed, prepare=prepare)
        return base_exp.fill_weights_(model, self.model_name_or_path, _no_release_converter, cfg)


@dataclass
class NaVILADataConfig(base_exp.DataConfig):
    """Video-frame navigation data: DexNavilaDataset in place of DexDataset."""

    num_video_frames: int = 8

    def build_data(self, tokenization_func, action_process_func=None):
        from dexbotic_tpu_torch.data.dex_navila_dataset import DexNavilaDataset
        from dexbotic_tpu_torch.data.image_processing import PixelAug, PreprocessRGB

        aug = (PixelAug(self.aug_policy)
               if self.aug_policy and not isinstance(self.aug_policy, list) else None)
        img_fn = PreprocessRGB(self.build_image_processor(),
                               image_aspect_ratio=self.image_aspect_ratio, augmentations=aug,
                               image_pad_mode=self.image_pad_mode)
        return DexNavilaDataset(dataset_name=self.dataset_name, tokenization_func=tokenization_func,
                                action_process_func=action_process_func,
                                image_process_func=[img_fn] * self.num_video_frames,
                                num_video_frames=self.num_video_frames, data_keys=self.data_keys)


@dataclass
class NaVILAExp(base_exp.BaseExp):
    exp_name: str = "navila"
    model: NaVILAModelConfig = field(default_factory=NaVILAModelConfig)
    tokenizer: base_exp.TokenizerConfig = field(
        default_factory=lambda: base_exp.TokenizerConfig(model_max_length=4096,
                                                         chat_template="llama_3"))
    action: base_exp.ActionConfig = field(
        default_factory=lambda: base_exp.ActionConfig(prompt_template=NAV_PROMPT))
    data: NaVILADataConfig = field(
        default_factory=lambda: NaVILADataConfig(num_images=8, image_processor="siglip_384",
                                                 data_keys=["input_ids", "labels", "image"]))

    def num_image_tokens(self) -> int:
        return self.model.build_config().vlm.num_image_tokens

    def _digit_ids(self, tokenizer) -> torch.Tensor:
        """The numeric tokens of the soft CE: the ids of "0".."9"."""
        return torch.tensor([tokenizer.encode(str(d))[-1] for d in range(10)], dtype=torch.int32,
                            device=self.device)

    def _soft_tokens(self, tokenizer) -> Optional[torch.Tensor]:
        return self._digit_ids(tokenizer) if self.model.use_soft_ce else None

    def build_model(self, tokenizer):
        """(config, fp32 model on ``device``, the unpacked loss_fn(model, batch, generator))."""
        cfg = self.model.build_config()
        model = self.model.build_params(cfg, self.device)
        soft, remat = self._soft_tokens(tokenizer), self.trainer.gradient_checkpointing

        def loss_fn(model, batch, generator):
            return navila_loss(model, cfg, batch, soft_tokens=soft, remat=remat)

        return cfg, model, loss_fn

    def pack_max_len_resolved(self) -> int:
        return self.model.pack_max_len or self.tokenizer.model_max_length

    def packed_batches(self, dataset, collator, pad_token_id: int, rows: int,
                       process_id: int = 0, process_count: int = 1):
        """Packed steps, epoch after epoch: ``samples_per_pack`` samples of
        similar lengths (the length-grouped schedule, seeded by the trainer's
        seed + the epoch), collated, then packed into ``rows`` rows of
        ``pack_max_len_resolved()`` tokens; ``images`` are the samples'
        frames, unpacked.  Over ``process_count`` data ranks the schedule's
        groups hold that many times the samples, and each rank packs its own
        contiguous share into its own rows."""
        K = self.model.samples_per_pack or 2 * rows
        max_len = self.pack_max_len_resolved()
        lengths = (dataset.length_hints() if hasattr(dataset, "length_hints")
                   else [1] * len(dataset))
        epoch = 0
        while True:
            for idxs in length_grouped_batches(lengths, K * process_count,
                                               seed=self.trainer.seed + epoch):
                if len(idxs) < K * process_count:
                    continue
                idxs = idxs[process_id * K: (process_id + 1) * K]
                base = collator([dataset[i] for i in idxs])
                packed = pack_batch(base["input_ids"], base["labels"],
                                    base["attention_mask"].astype(np.int64), num_rows=rows,
                                    max_len=max_len, pad_token_id=pad_token_id)
                packed["images"] = base["images"].astype(np.float32)
                yield packed
            epoch += 1

    def train(self) -> dict:
        """Length-grouped, packed training (``use_packing``, the default);
        unpacked rows through the base loop otherwise."""
        if not self.model.use_packing:
            return super().train()
        if self.trainer.gradient_accumulation_steps != 1:
            raise ValueError("packed NaVILA training packs the whole step; use more rows "
                             "instead of gradient accumulation")
        from dexbotic_tpu_torch.data.collator import Collator
        from dexbotic_tpu_torch.exp.trainer import Trainer
        from dexbotic_tpu_torch.parallel import multihost

        multihost.maybe_initialize(device=self.device)
        tokenizer = self.tokenizer.build_tokenizer()
        cfg = self.model.build_config()
        model = self.model.build_params(cfg, self.device)
        soft, remat = self._soft_tokens(tokenizer), self.trainer.gradient_checkpointing

        def loss_fn(model, batch, generator):
            return navila_packed_loss(model, cfg, batch, soft_tokens=soft, remat=remat)

        dataset = self.data.build_data(self.build_tokenization(tokenizer))
        collator = Collator(pad_token_id=tokenizer.pad_token_id,
                            max_length=self.tokenizer.model_max_length)
        trainer = Trainer(loss_fn, model, self.trainer, self.optimizer)
        try:
            return trainer.train(self.packed_batches(
                dataset, collator, tokenizer.pad_token_id, self.trainer.per_device_batch_size,
                process_id=trainer.data_rank, process_count=trainer.data_size))
        finally:
            trainer.close()

    def make_generate_fn(self, cfg: NaVILAConfig, model, max_new_tokens: int = 48,
                         eos_token_id: int = 0):
        """(ids, valid, images, generator) -> greedy tokens [B, max_new_tokens]."""

        def gen(ids, valid, images, generator=None):
            return generate(model.vlm, cfg.vlm, ids, valid, images, max_new_tokens=max_new_tokens,
                            eos_token_id=eos_token_id, generator=generator)[0]

        return gen


def _stop_string(exp: NaVILAExp) -> str:
    conv = conversation_lib.conv_templates[exp.tokenizer.chat_template]
    return getattr(conv, "sep2", None) or conv.sep


class NaVILAInferenceSession:
    """The frame history and the text decoding of one navigation stream.
    The chat template's stop string ends generation as the EOS id when it is
    one token (else id 0).  With a shared ``engine`` (continuous batching of
    a fleet's sessions, :meth:`make_shared_engine`) the session's requests
    join the engine's slots, and its text stops at the EOS id and at id 0
    (the engine's own EOS), as the JAX session's does."""

    def __init__(self, exp: NaVILAExp, cfg: NaVILAConfig, model, tokenizer, engine=None,
                 max_new_tokens: int = 32):
        self.exp, self.cfg, self.tokenizer = exp, cfg, tokenizer
        self.engine = engine
        self.device = torch.device(exp.device)
        self.buffer = FrameHistoryBuffer(cfg.num_video_frames)
        stop = _stop_string(exp)
        stop_ids = tokenizer.encode(stop, add_bos=False) if stop else []
        self.eos_token_id = stop_ids[0] if len(stop_ids) == 1 else 0
        self.max_new_tokens = max_new_tokens
        self.gen = None if engine is not None else exp.make_generate_fn(
            cfg, model, max_new_tokens=max_new_tokens, eos_token_id=self.eos_token_id)

    @staticmethod
    def make_shared_engine(cfg: NaVILAConfig, model, slots: int = 8, max_new_tokens: int = 48,
                           max_prompt: int = 2048, prefill_chunk: int = 0):
        """One decode engine for a fleet of sessions (EOS id 0).  A history
        prompt runs to 2k tokens: ``prefill_chunk`` (e.g. 512) keeps the
        fleet's in-flight decodes ticking during those prefills.  Size
        ``max_prompt`` to the prompt (2195 tokens at 8 frames of 196 with
        the served instruction): the JAX default, 2048, is below it."""
        from dexbotic_tpu_torch.exp.decode_engine import ContinuousBatchingEngine

        return ContinuousBatchingEngine(model.vlm, cfg.vlm, slots=slots, max_prompt=max_prompt,
                                        max_new=max_new_tokens, eos_token_id=0,
                                        prefill_chunk=prefill_chunk or None)

    def reset(self) -> None:
        self.buffer.reset()

    def observe(self, frame: np.ndarray) -> None:
        """Append a frame to the history without running the model."""
        self.buffer.frames.append(frame)

    def prompt_ids(self, instruction: str, n_frames: int) -> list:
        """The served prompt: the nav question in the chat template, an empty
        assistant turn, each image tag expanded to the frame's tokens."""
        from dexbotic_tpu_torch.tokenization.tokenize import tokenizer_image_token

        conv = conversation_lib.conv_templates[self.exp.tokenizer.chat_template].copy()
        conv.append_message(conv.roles[0], nav_question(instruction, n_frames))
        conv.append_message(conv.roles[1], None)
        return tokenizer_image_token(conv.get_prompt(), self.tokenizer,
                                     num_image_tokens=self.cfg.vlm.num_image_tokens)

    def host_inputs(self, frame: np.ndarray, instruction: str) -> tuple[list, np.ndarray]:
        """(prompt ids, images [n_frames, H, W, 3]) of a request on
        ``frame``, which joins the history."""
        from dexbotic_tpu_torch.data.image_processing import preprocess_image

        frames = self.buffer.add(frame)
        proc = self.exp.data.build_image_processor()
        imgs = np.stack([preprocess_image(f, proc) for f in frames])
        return self.prompt_ids(instruction, len(frames)), imgs

    def inputs(self, frame: np.ndarray, instruction: str):
        """(ids [1, S], valid, images [1, n_frames, H, W, 3]) of a request
        on ``frame``, which joins the history, on the session's device."""
        ids, imgs = self.host_inputs(frame, instruction)
        ids = torch.tensor([ids], dtype=torch.int32, device=self.device)
        return ids, torch.ones_like(ids), torch.from_numpy(imgs)[None].to(self.device)

    def act(self, frame: np.ndarray, instruction: str,
            generator: Optional[torch.Generator] = None) -> str:
        if self.engine is not None:
            ids, imgs = self.host_inputs(frame, instruction)
            toks = self.engine.submit(np.asarray(ids, np.int32), images=imgs,
                                      max_new=self.max_new_tokens)
            for stop in (self.eos_token_id, 0):
                if stop in toks:
                    toks = toks[: toks.index(stop)]
            return self._postprocess(self.tokenizer.decode(toks))
        tokens = self.gen(*self.inputs(frame, instruction), generator)
        return self._postprocess(self.tokenizer.decode([int(t) for t in tokens[0].tolist()]))

    def _postprocess(self, text: str) -> str:
        """Strip, drop a trailing stop string, strip again (text after a NUL
        character is cut first)."""
        stop = _stop_string(self.exp)
        text = text.split("\x00")[0] if "\x00" in text else text
        text = text.strip()
        if stop and text.endswith(stop):
            text = text[: -len(stop)]
        return text.strip()


if __name__ == "__main__":
    NaVILAExp.main()
