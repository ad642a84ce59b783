"""CogACT as the program serves it: ``CogActExp`` (``llm_preset`` and the
other fields from the configuration file), its ``build_config`` and
``build_params``, the benchmark's seeded weights copied in, and
``CogActServer`` from ``exp/serve.py``.

Besides the system under test this file holds what the harness needs to
know of it: the widths it checks against the configuration file, the
wrappers that record spans and the noise of each device call, and the
model FLOPs of one answered chunk.
"""

from __future__ import annotations

import numpy as np
import torch

from vlabench import weights, yardstick
from vlabench.reference import cogact as ref

def make_exp(config: dict, seed: int, device: str, quantize: str = ""):
    from dexbotic_tpu_torch.exp.cogact_exp import CogActExp, CogActModelConfig

    e, head = config["exp"], config["action_head"]
    exp = CogActExp(
        model=CogActModelConfig(
            llm_preset=e["llm_preset"], vit_preset=e["vit_preset"],
            mm_projector_type=config["projector"]["type"], action_model_type=e["action_model_type"],
            action_dim=head["action_dim"], chunk_size=head["chunk_size"],
            ddim_steps=head["ddim_steps"], seed=seed),
        device=device, inference_quantize=quantize)
    if "inference_quantize_min_size" in e:  # a test's tiny weights are all under the default
        exp.inference_quantize_min_size = e["inference_quantize_min_size"]
    exp.data.image_processor = e["image_processor"]
    exp.tokenizer.chat_template = e["chat_template"]
    return exp


def check_widths(exp, cfg, config: dict) -> None:
    """The program's built configuration against the configuration file."""
    llm, vit, dit = cfg.vlm.llm, cfg.vlm.vit, cfg.dit
    proc = exp.data.build_image_processor()
    L, V, H = config["llm"], config["vision"], config["action_head"]
    pairs = [
        (llm.vocab_size, L["vocab_size"]), (llm.hidden_size, L["hidden_size"]),
        (llm.num_layers, L["num_hidden_layers"]), (llm.num_heads, L["num_attention_heads"]),
        (llm.num_kv_heads, L["num_key_value_heads"]), (llm.head_dim, L["head_dim"]),
        (llm.intermediate_size, L["intermediate_size"]), (llm.rope_theta, L["rope_theta"]),
        (llm.rms_eps, L["rms_norm_eps"]), (llm.attn_bias, L["attention_bias"]),
        (llm.tie_embeddings, L["tie_word_embeddings"]), (llm.act, L["hidden_act"]),
        (vit.image_size, V["image_size"]), (vit.patch_size, V["patch_size"]),
        (vit.hidden_size, V["hidden_size"]), (vit.num_layers, V["num_hidden_layers"]),
        (vit.num_heads, V["num_attention_heads"]), (vit.intermediate_size, V["intermediate_size"]),
        (vit.act, V["hidden_act"]), (vit.ln_eps, V["layer_norm_eps"]), (vit.use_cls, V["cls_token"]),
        (vit.pre_ln, V["pre_layernorm"]), (vit.select_layer, V["select_layer"]),
        (dit.hidden_size, H["hidden_size"]), (dit.depth, H["depth"]), (dit.num_heads, H["num_heads"]),
        (dit.mlp_ratio, H["mlp_ratio"]), (dit.in_channels, H["action_dim"]),
        (dit.chunk_size, H["chunk_size"]), (dit.freq_embed_size, H["freq_embed_size"]),
        (cfg.diffusion_steps, H["diffusion_steps"]), (cfg.ddim_steps, H["ddim_steps"]),
        (cfg.cfg_scale, H["cfg_scale"]), (cfg.sampler, "ddim"), (proc.size, V["image_size"]),
        (list(proc.mean), V["image_mean"]), (list(proc.std), V["image_std"]),
    ]
    bad = [(a, b) for a, b in pairs if a != b]
    if bad:
        raise ValueError(f"the program's configuration differs from the file: {bad}")


def build(config: dict, weight_seed: int, server_seed: int, device: str, quantize: str = ""):
    """(exp, program config, served model holding the benchmark's weights);
    ``server_seed`` seeds the server's noise generator."""
    exp = make_exp(config, server_seed, device, quantize)
    cfg = exp.model.build_config()
    check_widths(exp, cfg, config)
    model = exp.model.build_params(cfg, device, prepare=exp.prepare_inference_params)
    weights.fill_(model, ref.inventory(config), weight_seed)
    exp.quantize_inference_model(model)
    return exp, cfg, model


def norm_stats(config: dict, seed: int) -> dict:
    """The served action statistics, drawn from the seed: per dim a min in
    [-1, 0] and a max 0.5 to 1.5 above it."""
    rng = np.random.default_rng(seed)
    A = config["action_head"]["action_dim"]
    lo = rng.uniform(-1.0, 0.0, A)
    return {"min": lo.tolist(), "max": (lo + rng.uniform(0.5, 1.5, A)).tolist()}


def make_server(exp, cfg, model, norms, traffic: dict):
    from dexbotic_tpu_torch.exp.serve import CogActServer

    return CogActServer(exp, cfg, model, exp.tokenizer.build_tokenizer(), norms,
                        host="127.0.0.1", port=0, micro_batch=traffic["micro_batch"],
                        micro_batch_window_ms=traffic["micro_batch_window_ms"])


class Recorder:
    """Wraps the server's batch entry and its policy call: each device call
    is recorded with the requests it answered (their ``vb_id`` form field),
    its padded rows, the state of the server's generator before the call,
    so that the reference draws the same noise, and the cognition features
    the call computed (``cognition_feature``'s result, kept on the device).
    With ``spans`` on, the calls also record spans (and the policy span
    waits for its result).  ``close`` undoes the wrapping."""

    def __init__(self, server, spans):
        from dexbotic_tpu_torch.models import cogact as cogact_mod

        self.server, self.spans = server, spans
        self.calls: list = []
        self._ids = self._call = None
        batch, infer = server.get_batched_response, server.infer
        self._feature = feature = cogact_mod.cognition_feature

        def cognition_feature(*args, **kw):
            cog, hidden = feature(*args, **kw)
            if self._call is not None:
                self._call["z"] = cog
            return cog, hidden

        def get_batched_response(requests):
            self._ids = [int(f["vb_id"]) for f, _ in requests]
            with spans.span("batch", rows=len(requests)):
                return batch(requests)

        def policy(ids, valid, imgs, generator):
            call = {"ids": self._ids, "padded": int(ids.shape[0]),
                    "state": generator.get_state().clone()}
            self.calls.append(call)
            self._call = call
            with spans.span("policy", requests=self._ids) as s:
                out = infer(ids, valid, imgs, generator)
                if spans.on:
                    if ids.device.type == "cuda":
                        torch.cuda.synchronize(ids.device)
                    s["tokens"] = [int(v) for v in valid.sum(1).tolist()]
                return out

        server.get_batched_response = get_batched_response
        server.infer = policy
        cogact_mod.cognition_feature = cognition_feature

    def close(self) -> None:
        from dexbotic_tpu_torch.models import cogact as cogact_mod

        cogact_mod.cognition_feature = self._feature


def install_kernel_spans(spans):
    """Spans around K1 (the decoder's attention entry) and K2 (the fused
    sampler's entry), each with the work of its call; returns an undo."""
    from dexbotic_tpu_torch.models import cogact as cogact_mod
    from dexbotic_tpu_torch.nn import transformer

    attn, sampler = transformer.attention, cogact_mod.fused_dit_sample

    def attention(q, k, v, q_grp, kv_grp, kv_valid, *a, **kw):
        with spans.span("k1", shapes=(tuple(q.shape), tuple(k.shape)), elem=q.element_size(),
                        masks=(q_grp, kv_grp, kv_valid)):
            return attn(q, k, v, q_grp, kv_grp, kv_valid, *a, **kw)

    def fused(h, dcfg, z, noise, sched, *, steps, cfg_scale, **kw):
        B, T, A = noise.shape
        ops, nbytes = yardstick.dit_sample(B, T, A, dcfg.hidden_size, dcfg.mlp_dim, dcfg.depth,
                                           steps, z.shape[-1], cfg_scale > 1.0)
        with spans.span("k2", ops=ops, bytes=nbytes):
            return sampler(h, dcfg, z, noise, sched, steps=steps, cfg_scale=cfg_scale, **kw)

    transformer.attention = attention
    cogact_mod.fused_dit_sample = fused

    def undo():
        transformer.attention = attn
        cogact_mod.fused_dit_sample = sampler

    return undo


def chunk_flops(config: dict, prompt_tokens: int) -> float:
    """Model FLOPs of one answered chunk: the tower and projector over its
    frame, the decoder over its valid tokens (image tokens included, causal
    pairs), and the guided DDIM samples of the action head."""
    L, V, H = config["llm"], config["vision"], config["action_head"]
    grid = V["image_size"] // V["patch_size"]
    patches = grid * grid
    tokens = patches + (1 if V["cls_token"] else 0)
    layers = V["num_hidden_layers"] if V["select_layer"] is None \
        else V["num_hidden_layers"] + V["select_layer"] + 1
    f = yardstick.vit_flops(1, tokens, V["hidden_size"], V["intermediate_size"], layers,
                            V["patch_size"] ** 2 * 3, patches)
    f += 2.0 * patches * (V["hidden_size"] * L["hidden_size"] + L["hidden_size"] ** 2)
    n = prompt_tokens
    f += yardstick.decoder_flops(n, L["hidden_size"], L["num_attention_heads"], L["num_key_value_heads"],
                                 L["head_dim"], L["intermediate_size"], L["num_hidden_layers"],
                                 n * (n + 1) / 2)
    D = H["hidden_size"]
    ops, _ = yardstick.dit_sample(1, H["chunk_size"], H["action_dim"], D, int(D * H["mlp_ratio"]),
                                  H["depth"], H["ddim_steps"], L["hidden_size"], H["cfg_scale"] > 1.0)
    return f + ops
