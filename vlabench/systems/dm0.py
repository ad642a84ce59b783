"""DM0 as the program trains it: the recipe's exp (``LiberoDM0Exp``), its
``build_model`` (configuration, fp32 model, ``flow_vla_loss``), the
benchmark's seeded weights copied in, and the port's ``Trainer`` with the
recipe's trainer and optimizer settings; the samples go through the port's
tokenization, image processor, ``Collator``, ``DataLoader`` (thread workers)
and ``device_prefetch``, as ``BaseExp.train`` feeds them.

Besides the system under test this file holds what the harness needs to
know of it: the widths it checks against the configuration file, the
wrappers that record spans, and the model FLOPs of one trained sample.
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import torch

from vlabench import core, weights, yardstick
from vlabench.reference import dm0 as ref


def make_exp(config: dict, train_seed: int, output_dir: str, device: str):
    mod = importlib.import_module(config["exp"]["module"])
    exp = getattr(mod, config["exp"]["class"])(device=device)
    for block, values in config["exp"].get("overrides", {}).items():  # a test's small sizes
        setattr(exp, block, dataclasses.replace(getattr(exp, block), **values))
    exp.trainer = dataclasses.replace(exp.trainer, output_dir=output_dir, logging_steps=1,
                                      seed=train_seed)
    return exp


def check_widths(exp, cfg, config: dict) -> None:
    """The program's built configuration and recipe against the configuration file."""
    V, X, S, F, T = config["vlm"], config["expert"], config["vision"], config["flow"], config["train"]
    pairs = []
    for d, c in ((V, cfg.llm), (X, cfg.expert)):
        pairs += [(c.hidden_size, d["hidden_size"]), (c.num_layers, d["num_hidden_layers"]),
                  (c.num_heads, d["num_attention_heads"]), (c.num_kv_heads, d["num_key_value_heads"]),
                  (c.head_dim, d["head_dim"]), (c.intermediate_size, d["intermediate_size"]),
                  (c.act, d["hidden_act"]), (c.rope_theta, d["rope_theta"]), (c.rms_eps, d["rms_norm_eps"]),
                  (c.attn_bias, d["attention_bias"]), (c.qk_norm, d["qk_norm"]), (c.norm_offset, 0.0),
                  (c.embed_scale, False), (c.adarms_cond_dim, None), (c.moe_num_experts, None)]
    vit = cfg.vit
    proc = exp.data.build_image_processor()
    tr, op = exp.trainer, exp.optimizer
    pairs += [(cfg.llm.vocab_size, V["vocab_size"]), (cfg.llm.tie_embeddings, V["tie_word_embeddings"]),
              (cfg.expert.has_embed, False),
              (vit.image_size, S["image_size"]), (vit.patch_size, S["patch_size"]),
              (vit.hidden_size, S["hidden_size"]), (vit.num_layers, S["num_hidden_layers"]),
              (vit.num_heads, S["num_attention_heads"]), (vit.intermediate_size, S["intermediate_size"]),
              (vit.act, S["hidden_act"]), (vit.ln_eps, S["layer_norm_eps"]), (vit.use_cls, S["cls_token"]),
              (vit.pre_ln, S["pre_layernorm"]), (vit.select_layer, S["select_layer"]),
              (cfg.projector_type, config["projector"]["type"]), (cfg.action_dim, F["action_dim"]),
              (cfg.chunk_size, F["chunk_size"]), (cfg.num_flow_steps, F["num_flow_steps"]),
              (cfg.causal_prefix, F["causal_prefix"]), (cfg.use_state_token, False),
              (cfg.time_in_suffix, True), (cfg.adarms, False), (cfg.progress_token, False),
              (exp.data.num_images, config["views"]), (exp.tokenizer.model_max_length, config["text_tokens"]),
              (exp.tokenizer.chat_template, config["chat_template"]),
              (proc.size, S["image_size"]), (list(proc.mean), S["image_mean"]), (list(proc.std), S["image_std"]),
              (tr.per_device_batch_size, T["per_device_batch_size"]),
              (tr.gradient_accumulation_steps, T["gradient_accumulation_steps"]),
              (tr.gradient_checkpointing, T["gradient_checkpointing"]), (tr.bf16, T["bf16"]),
              (tr.max_steps, T["max_steps"]), (op.learning_rate, T["learning_rate"]),
              (op.lr_scheduler_type, T["lr_scheduler_type"]), (op.warmup_ratio, T["warmup_ratio"]),
              (op.adam_beta1, T["adam_beta1"]), (op.adam_beta2, T["adam_beta2"]), (op.adam_eps, T["adam_eps"]),
              (op.weight_decay, T["weight_decay"]), (op.max_grad_norm, T["max_grad_norm"]),
              (op.freeze_llm or op.freeze_mm_vision or op.freeze_mm_projector, False),
              (op.mm_projector_lr, None), (op.mm_vision_lr, None), (op.action_head_lr, None)]
    bad = [(a, b) for a, b in pairs if a != b]
    if bad:
        raise ValueError(f"the program's configuration differs from the file: {bad}")


def build(config: dict, weight_seed: int, train_seed: int, output_dir: str, device: str):
    """(exp, the trainer holding the benchmark's weights, its tokenizer)."""
    from dexbotic_tpu_torch.exp.trainer import Trainer

    exp = make_exp(config, train_seed, output_dir, device)
    tokenizer = exp.tokenizer.build_tokenizer()
    cfg, model, loss_fn = exp.build_model(tokenizer)
    check_widths(exp, cfg, config)
    weights.fill_(model, ref.inventory(config), weight_seed)
    trainer = Trainer(loss_fn, model, exp.trainer, exp.optimizer)
    stored = {n: p.dtype for n, p in trainer.params.items()}
    want = {n: torch.bfloat16 if ref.stored_bf16(n, p.shape) else torch.float32
            for n, p in trainer.params.items()}
    if stored != want:
        diff = sorted(n for n in stored if stored[n] != want[n])
        raise ValueError(f"the program stores leaves other than the configuration states: {diff[:5]}")
    return exp, trainer, tokenizer


class Samples:
    """The benchmark's seeded samples, turned into the program's training
    items by its tokenization and image processor (the work of the recipe's
    data pipeline on each item)."""

    def __init__(self, exp, tokenizer, make_sample, count: int):
        from dexbotic_tpu_torch.data.image_processing import preprocess_image

        self.tok = exp.build_tokenization(tokenizer)
        self.proc = exp.data.build_image_processor()
        self.prep = preprocess_image
        self.make_sample = make_sample
        self.count = count

    def __len__(self) -> int:
        return self.count

    def __getitem__(self, i: int) -> dict:
        frames, text, actions, state = self.make_sample(i)
        out = self.tok([{"from": "human", "value": text}, {"from": "gpt", "value": ""}])
        return {"input_ids": out["input_ids"], "labels": out["labels"], "token_mask": out["token_mask"],
                "image": np.stack([self.prep(f, self.proc) for f in frames]),
                "image_masks": np.ones(len(frames), np.int32), "action": actions, "state": state}


def make_loader(exp, tokenizer, trainer, samples: Samples, workers: int):
    """The recipe's feed: the collated global batches of a thread-worker
    ``DataLoader``, moved to the device ahead of the step by ``device_prefetch``."""
    from dexbotic_tpu_torch.data.collator import Collator
    from dexbotic_tpu_torch.data.loader import DataLoader, device_prefetch

    tr = exp.trainer
    collator = Collator(pad_token_id=tokenizer.pad_token_id, max_length=exp.tokenizer.model_max_length)
    batch = tr.per_device_batch_size * tr.gradient_accumulation_steps
    loader = DataLoader(samples, collator, batch, shuffle=True, num_workers=workers,
                        worker_mode="thread", seed=tr.seed)
    return device_prefetch(iter(loader), trainer.device)


def install_spans(trainer, spans):
    """Spans around the optimizer's update, K1 (the decoder's attention
    entry, forward and its recomputation) and K3 (the flash backward's
    entry), each with the shapes of its call; returns an undo."""
    from dexbotic_tpu_torch.nn import transformer
    from dexbotic_tpu_torch.ops import attention as attn_mod

    attn, bwd, opt_step = transformer.attention, attn_mod.flash_attention_bwd, trainer.optimizer.step_

    def attention(q, k, v, q_grp, kv_grp, kv_valid, *a, **kw):
        with spans.span("k1", shapes=(tuple(q.shape), tuple(k.shape)), elem=q.element_size(),
                        masks=(q_grp, kv_grp, kv_valid)):
            return attn(q, k, v, q_grp, kv_grp, kv_valid, *a, **kw)

    def flash_attention_bwd(q, k, v, q_grp, kv_grp, kv_valid, *a, **kw):
        with spans.span("k3", shapes=(tuple(q.shape), tuple(k.shape)), elem=q.element_size(),
                        masks=(q_grp, kv_grp, kv_valid)):
            return bwd(q, k, v, q_grp, kv_grp, kv_valid, *a, **kw)

    def step_(params, grads):
        core.sync()
        with spans.span("optim"):
            out = opt_step(params, grads)
            core.sync()
            return out

    transformer.attention = attention
    # the port counts K3's launches on the module's entry, which the span now is
    flash_attention_bwd.launches = bwd.launches
    attn_mod.flash_attention_bwd = flash_attention_bwd
    trainer.optimizer.step_ = step_

    def undo():
        transformer.attention = attn
        bwd.launches = flash_attention_bwd.launches
        attn_mod.flash_attention_bwd = bwd
        del trainer.optimizer.step_

    return undo


def sample_flops(config: dict, text_valid: int) -> float:
    """Model FLOPs of one trained sample: the forward of the tower over each
    view, the projector, the VLM over its valid prefix tokens, the expert
    over the chunk and the joint attention's visible pairs, and the
    backward at twice the products' forward and 2.5 times attention's
    (remat's recomputation not counted)."""
    V, X, S, F = config["vlm"], config["expert"], config["vision"], config["flow"]
    views = config["views"]
    patches = (S["image_size"] // S["patch_size"]) ** 2
    vit = views * yardstick.vit_flops(1, patches, S["hidden_size"], S["intermediate_size"],
                                      S["num_hidden_layers"], S["patch_size"] ** 2 * 3, patches)
    vit_attn = views * S["num_hidden_layers"] * 4.0 * patches * patches * S["hidden_size"]
    proj = 2.0 * views * patches * S["hidden_size"] * V["hidden_size"]
    P = views * patches + text_valid
    C = F["chunk_size"]
    pairs = P * (P + 1) / 2 + C * (P + C)
    vlm = yardstick.decoder_flops(P, V["hidden_size"], V["num_attention_heads"], V["num_key_value_heads"],
                                  V["head_dim"], V["intermediate_size"], V["num_hidden_layers"], 0)
    ex = yardstick.decoder_flops(C, X["hidden_size"], X["num_attention_heads"], X["num_key_value_heads"],
                                 X["head_dim"], X["intermediate_size"], X["num_hidden_layers"], 0)
    attn = V["num_hidden_layers"] * 4.0 * V["head_dim"] * V["num_attention_heads"] * pairs
    E, A = X["hidden_size"], F["action_dim"]
    heads = 2.0 * C * (A * E + 2 * E * E + E * E + E * A)
    matmuls = vit - vit_attn + proj + vlm + ex + heads
    return 3.0 * matmuls + 3.5 * (attn + vit_attn)
