"""Released Dexbotic/HF checkpoint -> the port's parameter trees.

Port of dexbotic_tpu/utils/convert.py.  The reference's checkpoints (CogACT
in LLaVA layout, pi0/pi0.5 as PaliGemma + a Gemma expert, DM0 as a Qwen3
pair) map onto the JAX package's parameter trees, which ``utils/bridge.py``
copies into the port's modules:

  * a torch Linear's ``[out, in]`` weight becomes ``[in, out]`` (a transposed
    view here; the bridge transposes it back, so no copy is made);
  * per-layer dicts become ``layers`` / ``blocks`` subtrees whose leaves are
    lists of the per-layer tensors, standing for the JAX tree's stacks on a
    leading axis; the bridge indexes them layer by layer, so no stacked copy
    is made;
  * a CLIP/SigLIP conv patch embed ``[H, 3, p, p]`` becomes ``[p*p*3, H]``
    in patchify's (row, col, channel) order.

Tensors stay in the file's own dtype (a bf16 7B checkpoint is 14 GB, not
the 28 GB of an fp32 copy); the bridge casts each leaf into its parameter's
dtype.  ``.safetensors`` files are read by this module's own parser (an
8-byte little-endian header length, a JSON header, then the raw bytes) over
a private file mapping, so neither the ``safetensors`` package nor numpy
takes part and bf16 reads as bf16; ``.bin`` / ``.pt`` files go through
``torch.load(weights_only=True)``.

MUVLA's fuser and history QFormer hold torch ``nn.MultiheadAttention``s:
their packed ``in_proj_weight`` splits into the q, k and v linears.
"""

from __future__ import annotations

import json
import math
import os
import re
import struct

import torch

SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
    "F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2,
}
CHECKPOINT_SUFFIXES = (".safetensors", ".bin", ".pt")


def read_safetensors(path: str, device="cpu") -> dict:
    """{name: tensor} of one ``.safetensors`` file, each tensor in its stored
    dtype and shape.  On the CPU the tensors are views of a private mapping of
    the file (pages are read as they are touched); on another device each is
    copied there, and the mapping goes once the caller drops the views."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    size = os.path.getsize(path)
    data = torch.from_file(path, shared=False, size=size, dtype=torch.uint8)
    base = 8 + n
    device = torch.device(device)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = SAFETENSORS_DTYPES[info["dtype"]]
        start, end = (base + o for o in info["data_offsets"])
        shape = info["shape"]
        raw = data[start:end]
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - start != itemsize * math.prod(shape) or end > size:
            raise ValueError(f"{path}: {name} holds {end - start} bytes for {shape} {dtype}")
        if start % itemsize:  # a view must start on an element boundary
            raw = raw.clone()
        t = raw.view(dtype).reshape(shape)
        out[name] = t if device.type == "cpu" else t.to(device)
    return out


def checkpoint_files(path: str) -> list[str]:
    """The weight files of a checkpoint: ``path`` itself, or every
    ``.safetensors`` / ``.bin`` / ``.pt`` file of a directory, sorted."""
    if not os.path.isdir(path):
        return [path]
    return [os.path.join(path, f) for f in sorted(os.listdir(path))
            if f.endswith(CHECKPOINT_SUFFIXES)]


def is_release_checkpoint(path: str) -> bool:
    """A released (HF-layout) checkpoint, as opposed to the port's own
    ``checkpoint-{step}`` directory (``params.pt`` / ``adapter.pt``)."""
    if os.path.isdir(path):
        if any(os.path.exists(os.path.join(path, f)) for f in ("params.pt", "adapter.pt")):
            return False
        return bool(checkpoint_files(path))
    return path.endswith(CHECKPOINT_SUFFIXES)


def load_torch_state_dict(path: str, device="cpu") -> dict:
    """Load ``.safetensors`` / ``.bin`` / ``.pt`` file(s) or an HF directory of
    them -> {name: tensor} in each file's own dtype, on ``device``."""
    files = checkpoint_files(path)
    if not files:
        raise FileNotFoundError(f"no {'/'.join(CHECKPOINT_SUFFIXES)} files in {path}")
    out = {}
    for f in files:
        if f.endswith(".safetensors"):
            out.update(read_safetensors(f, device))
            continue
        try:
            sd = torch.load(f, map_location="cpu", weights_only=True, mmap=True)
        except RuntimeError:  # the legacy (non-zip) format cannot be mapped
            sd = torch.load(f, map_location="cpu", weights_only=True)
        for k, v in sd.items():
            out[k] = v if torch.device(device).type == "cpu" else v.to(device)
    return out


def _strip(sd: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _lin(sd: dict, name: str) -> dict:
    p = {"w": sd[f"{name}.weight"].t()}
    if f"{name}.bias" in sd:
        p["b"] = sd[f"{name}.bias"]
    return p


def _stack(dicts: list) -> dict:
    """List of per-layer parameter dicts -> one dict whose leaves are lists of
    the per-layer tensors (the JAX tree's stacked leaves, unstacked)."""
    first = dicts[0]
    if isinstance(first, dict):
        return {k: _stack([d[k] for d in dicts]) for k in first}
    return list(dicts)


# ---------------------------------------------------------------------------
# LLM (LLaMA / Qwen2 / Qwen3 / Gemma naming)
# ---------------------------------------------------------------------------


def _norm_params(sd: dict, name: str) -> dict:
    """RMSNorm weight, or pi0.5's adaRMS ``dense`` (condition -> scale,
    shift and gate): an adaptive norm holds a Linear instead of a vector."""
    if f"{name}.dense.weight" in sd:
        return {"dense": _lin(sd, f"{name}.dense")}
    return {"w": sd[f"{name}.weight"]}


def convert_llm(sd: dict, cfg, prefix: str = "") -> dict:
    """HF decoder state dict -> transformer params.  ``prefix`` example:
    'model.' (a bare LlamaModel), 'model.llm.' (a Dexbotic VLM)."""
    sd = _strip(sd, prefix)
    layers = []
    for i in range(cfg.num_layers):
        pre = f"layers.{i}."
        lp = {
            "ln1": _norm_params(sd, pre + "input_layernorm"),
            "ln2": _norm_params(sd, pre + "post_attention_layernorm"),
            "attn": {n: _lin(sd, f"{pre}self_attn.{n}_proj") for n in ("q", "k", "v", "o")},
            "mlp": {n: _lin(sd, f"{pre}mlp.{n}_proj") for n in ("gate", "up", "down")},
        }
        if cfg.qk_norm:
            lp["attn"]["q_norm"] = {"w": sd[pre + "self_attn.q_norm.weight"]}
            lp["attn"]["k_norm"] = {"w": sd[pre + "self_attn.k_norm.weight"]}
        layers.append(lp)
    params = {"layers": _stack(layers), "norm": _norm_params(sd, "norm")}
    if cfg.has_embed and "embed_tokens.weight" in sd:
        params["embed"] = {"embedding": sd["embed_tokens.weight"]}
    return params


def attach_lm_head(params: dict, sd: dict, cfg, key: str = "lm_head.weight") -> dict:
    """Add an untied decoder's ``lm_head``.  A tied one (``tie_embeddings``)
    holds none, as the port's module: a stored copy of the tied embedding is
    left out."""
    if key in sd and cfg.has_embed and not cfg.tie_embeddings:
        params["lm_head"] = {"w": sd[key].t()}
    return params


# ---------------------------------------------------------------------------
# Vision towers
# ---------------------------------------------------------------------------


def _conv_patch_to_matmul(w: torch.Tensor) -> torch.Tensor:
    """[H, C, p, p] conv kernel -> [p*p*C, H] for patchify's (row, col, chan)."""
    h, c, p, _ = w.shape
    return w.permute(2, 3, 1, 0).reshape(p * p * c, h)


def convert_vit(sd: dict, cfg, prefix: str = "vision_model.") -> dict:
    """CLIP/SigLIP HF vision model -> ViT params.  CLIP's patch embed has no
    bias (zeros here); SigLIP's pooling head is not used."""
    sd = _strip(sd, prefix)
    pe = sd["embeddings.patch_embedding.weight"]
    bias = sd.get("embeddings.patch_embedding.bias")
    params = {
        "patch_embed": {"w": _conv_patch_to_matmul(pe),
                        "b": bias if bias is not None else torch.zeros(pe.shape[0])},
        "pos_embed": sd["embeddings.position_embedding.weight"],
    }
    if cfg.use_cls and "embeddings.class_embedding" in sd:
        params["cls"] = sd["embeddings.class_embedding"]
    if cfg.pre_ln and "pre_layrnorm.weight" in sd:  # CLIP's spelling
        params["pre_ln"] = {"w": sd["pre_layrnorm.weight"], "b": sd["pre_layrnorm.bias"]}

    def ln(name):
        return {"w": sd[f"{name}.weight"], "b": sd[f"{name}.bias"]}

    layers = []
    for i in range(cfg.num_layers):
        pre = f"encoder.layers.{i}."
        layers.append({
            "ln1": ln(pre + "layer_norm1"),
            "ln2": ln(pre + "layer_norm2"),
            "attn": {**{n: _lin(sd, f"{pre}self_attn.{n}_proj") for n in ("q", "k", "v")},
                     "o": _lin(sd, pre + "self_attn.out_proj")},
            "mlp": {"fc1": _lin(sd, pre + "mlp.fc1"), "fc2": _lin(sd, pre + "mlp.fc2")},
        })
    params["layers"] = _stack(layers)
    if "post_layernorm.weight" in sd:
        params["post_ln"] = ln("post_layernorm")
    else:
        h = cfg.hidden_size
        params["post_ln"] = {"w": torch.ones(h), "b": torch.zeros(h)}
    return params


# ---------------------------------------------------------------------------
# Projector / DiT / full-policy assembly
# ---------------------------------------------------------------------------


def convert_projector(sd: dict, projector_type: str, prefix: str = "mm_projector.") -> dict:
    """'linear' / 'linear{N}x' (a bare nn.Linear, or one wrapped in a
    Sequential: '0.weight'), 'mlp{N}x_gelu' (Linears at the Sequential's even
    indices) and 'mlp_downsample' (LayerNorm at 1, Linears at 2 and 4)."""
    sd = _strip(sd, prefix)
    if projector_type == "linear" or re.match(r"^linear(\d+)x$", projector_type):
        if "weight" in sd:
            p = {"w": sd["weight"].t()}
            if "bias" in sd:
                p["b"] = sd["bias"]
            return {"fc": p}
        return {"fc": _lin(sd, "0")}
    if projector_type.startswith("mlp") and "downsample" not in projector_type:
        out, i = {}, 0
        while f"{i}.weight" in sd:
            out[f"fc{i // 2}"] = _lin(sd, str(i))
            i += 2
        return out
    if projector_type == "mlp_downsample":
        return {"ln": {"w": sd["1.weight"], "b": sd["1.bias"]},
                "fc0": _lin(sd, "2"), "fc1": _lin(sd, "4")}
    raise ValueError(projector_type)


def convert_dit(sd: dict, cfg, prefix: str = "action_head.net.") -> dict:
    """CogACT's or MemVLA's DiT head -> DiT params (models/dit.py layout).

    MemVLA's blocks add ``per_attn`` (torch ``MultiheadAttention``: the
    packed in_proj rows are [q; k; v]) and the affine ``norm3``; its head
    adds ``per_token_embedder``."""
    sd = _strip(sd, prefix)
    params = {
        "x_embed": _lin(sd, "x_embedder.linear"),
        "t_mlp": {"fc0": _lin(sd, "t_embedder.mlp.0"), "fc1": _lin(sd, "t_embedder.mlp.2")},
        "z_embed": _lin(sd, "z_embedder.linear"),
        "pos_embed": sd["positional_embedding"],
        "final": _lin(sd, "final_layer.linear"),
    }
    if "z_embedder.uncondition" in sd:
        params["uncondition"] = sd["z_embedder.uncondition"].reshape(-1)
    blocks = []
    for i in range(cfg.depth):
        pre = f"blocks.{i}."
        blk = {"attn": {"qkv": _lin(sd, pre + "attn.qkv"), "o": _lin(sd, pre + "attn.proj")},
               "mlp": {"fc0": _lin(sd, pre + "mlp.fc1"), "fc1": _lin(sd, pre + "mlp.fc2")}}
        if f"{pre}per_attn.in_proj_weight" in sd:
            w, b = sd[pre + "per_attn.in_proj_weight"], sd[pre + "per_attn.in_proj_bias"]
            h = w.shape[1]
            blk["xattn"] = {
                **{n: {"w": w[j * h: (j + 1) * h].t(), "b": b[j * h: (j + 1) * h]}
                   for j, n in enumerate("qkv")},
                "o": _lin(sd, pre + "per_attn.out_proj"),
                "ln": {"w": sd[pre + "norm3.weight"], "b": sd[pre + "norm3.bias"]},
            }
        blocks.append(blk)
    params["blocks"] = _stack(blocks)
    if "per_token_embedder.linear.weight" in sd:
        params["per_token_embedder"] = _lin(sd, "per_token_embedder.linear")
    return params


VIT_PREFIX = "model.mm_vision_tower.vision_tower.vision_model."


def convert_cogact(sd: dict, cfg) -> dict:
    """Full DB-CogACT checkpoint -> CogACT params."""
    llm = attach_lm_head(convert_llm(sd, cfg.vlm.llm, prefix="model.llm."), sd, cfg.vlm.llm)
    vit = convert_vit(sd, cfg.vlm.vit, prefix=VIT_PREFIX)
    proj = convert_projector(sd, cfg.vlm.projector_type, prefix="model.mm_projector.")
    dit = convert_dit(sd, cfg.dit, prefix="model.action_head.net.")
    return {"vlm": {"llm": llm, "vit": vit, "projector": proj}, "action_head": dit}


# the time MLP's two spellings: pi0's 'action_time_mlp_*', pi0.5's 'time_mlp_*'
FLOW_LINEARS = (("state_proj", "model.state_proj"),
                ("time_mlp_in", "model.action_time_mlp_in"),
                ("time_mlp_out", "model.action_time_mlp_out"),
                ("time_mlp_in", "model.time_mlp_in"),
                ("time_mlp_out", "model.time_mlp_out"))


def expert_prefix(sd: dict) -> str:
    """pi0/pi0.5 hold the expert as a bare decoder ('model.action_expert.');
    DM0 wraps it in a Qwen3ForCausalLM, one '.model.' deeper."""
    if any(k.startswith("model.action_expert.model.layers.") for k in sd):
        return "model.action_expert.model."
    return "model.action_expert."


def convert_flow_vla(sd: dict, cfg) -> dict:
    """pi0 / pi0.5 / DM0 checkpoint -> FlowVLA params."""
    llm = attach_lm_head(convert_llm(sd, cfg.llm, prefix="model.llm."), sd, cfg.llm)
    params = {
        "vlm": {"llm": llm, "vit": convert_vit(sd, cfg.vit, prefix=VIT_PREFIX),
                "projector": convert_projector(sd, cfg.projector_type,
                                               prefix="model.mm_projector.")},
        "expert": convert_llm(sd, cfg.expert, prefix=expert_prefix(sd)),
        "action_in_proj": _lin(sd, "model.action_in_proj"),
        "action_out_proj": _lin(sd, "model.action_out_proj"),
    }
    for ours, theirs in FLOW_LINEARS:
        if f"{theirs}.weight" in sd and ours not in params:
            params[ours] = _lin(sd, theirs)
    return params


# ---------------------------------------------------------------------------
# OFT heads (the reference's oft/action_model/model.py)
# ---------------------------------------------------------------------------


def _convert_mlp_resnet(sd: dict, prefix: str) -> dict:
    """The reference's MLPResNet (two residual blocks) -> ``models/oft.MLPResNet``'s
    tree (its ``blocks`` a Python list, as in JAX)."""
    sd = _strip(sd, prefix)

    def ln(name):
        return {"w": sd[f"{name}.weight"], "b": sd[f"{name}.bias"]}

    return {"ln1": ln("layer_norm1"), "fc1": _lin(sd, "fc1"), "ln2": ln("layer_norm2"),
            "fc2": _lin(sd, "fc2"),
            "blocks": [{"ln": ln(f"mlp_resnet_blocks.{i}.ffn.0"),
                        "fc": _lin(sd, f"mlp_resnet_blocks.{i}.ffn.1")}
                       for i in range(2)]}


def convert_oft(sd: dict, cfg) -> dict:
    """DB-OFT checkpoint (L1 / Diffusion / Discrete head) -> OFT params:
    ``model.action_head.{action_query, model.*, noisy_action_projector.*,
    noise_predictor.mlp_resnet.*, proprio_projector.*}``; the Discrete head
    has no parameters of its own (its bins are ``lm_head``'s logits)."""
    llm = attach_lm_head(convert_llm(sd, cfg.vlm.llm, prefix="model.llm."), sd, cfg.vlm.llm)
    vit = convert_vit(sd, cfg.vlm.vit, prefix=VIT_PREFIX)
    proj = convert_projector(sd, cfg.vlm.projector_type, prefix="model.mm_projector.")
    head: dict = {}
    t = cfg.action_model_type
    if "L1" in t:
        head["action_query"] = sd["model.action_head.action_query"][0]
        head["mlp"] = _convert_mlp_resnet(sd, "model.action_head.model.")
    elif "Diffusion" in t:
        head["noisy_action_projector"] = {
            n: _lin(sd, f"model.action_head.noisy_action_projector.{n}") for n in ("fc1", "fc2")}
        head["noise_predictor"] = _convert_mlp_resnet(
            sd, "model.action_head.noise_predictor.mlp_resnet.")
    if cfg.use_proprio:
        head["proprio_projector"] = {
            n: _lin(sd, f"model.action_head.proprio_projector.{n}") for n in ("fc1", "fc2")}
    return {"vlm": {"llm": llm, "vit": vit, "projector": proj}, "action_head": head}


# ---------------------------------------------------------------------------
# MemVLA (the reference's memvla/memvla_arch.py)
# ---------------------------------------------------------------------------


def _conv1x1(sd: dict, name: str) -> dict:
    """A 1x1 Conv2d [out, in, 1, 1] -> a per-token linear."""
    return {"w": sd[f"{name}.weight"][:, :, 0, 0].t(), "b": sd[f"{name}.bias"]}


def _convert_cross_block(sd: dict, prefix: str) -> dict:
    """A CrossTransformerBlock -> ``models/memvla.CrossBlock``'s tree."""
    sd = _strip(sd, prefix)

    def ln(name):
        return {"w": sd[f"{name}.weight"], "b": sd[f"{name}.bias"]}

    return {"q": _lin(sd, "q_proj"), "k": _lin(sd, "k_proj"), "v": _lin(sd, "v_proj"),
            "attn_ln": ln("attn_norm"),
            "ffn": {"fc1": _lin(sd, "ffn.0"), "fc2": _lin(sd, "ffn.3")},
            "ffn_ln": ln("ffn_norm")}


def convert_memvla(sd: dict, cfg) -> dict:
    """DB-MemVLA checkpoint -> MemVLA params: the CogACT policy plus the SE
    bottleneck (``model.per_compr``, 1x1 convs), each role's retrieval
    blocks, fusion gate and timestep embedder
    (``model.per_cog_mem_bank.*``) and the DiT with per-token
    cross-attention."""
    llm = attach_lm_head(convert_llm(sd, cfg.vlm.llm, prefix="model.llm."), sd, cfg.vlm.llm)
    vit = convert_vit(sd, cfg.vlm.vit, prefix=VIT_PREFIX)
    proj = convert_projector(sd, cfg.vlm.projector_type, prefix="model.mm_projector.")
    per_compr = {"excite": {"fc1": _conv1x1(sd, "model.per_compr.excite.1"),
                            "fc2": _conv1x1(sd, "model.per_compr.excite.3")},
                 "reduce": {"fc1": _conv1x1(sd, "model.per_compr.reduce.0"),
                            "fc2": _conv1x1(sd, "model.per_compr.reduce.2")}}
    bank = {}
    for role in ("per", "cog"):
        pre = "model.per_cog_mem_bank."
        role_p = {"retrieval": [_convert_cross_block(sd, f"{pre}retrieval_blocks.{role}.{i}.")
                                for i in range(cfg.retrieval_layers)]}
        gate = f"{pre}gate_fusion_blocks.{role}.proj"
        if f"{gate}.weight" in sd:
            role_p["gate"] = {"proj": _lin(sd, gate)}
        time = f"{pre}timestep_embedders.{role}.mlp"
        if f"{time}.0.weight" in sd:
            role_p["time"] = {"fc0": _lin(sd, f"{time}.0"), "fc1": _lin(sd, f"{time}.2")}
        bank[role] = role_p
    return {"vlm": {"llm": llm, "vit": vit, "projector": proj}, "per_compr": per_compr,
            "mem_bank": bank, "action_head": convert_dit(sd, cfg.dit, prefix="model.action_head.net.")}


# ---------------------------------------------------------------------------
# MUVLA (the reference's muvla/muvla_arch.py)
# ---------------------------------------------------------------------------


def _convert_torch_mha(sd: dict, prefix: str) -> dict:
    """torch ``nn.MultiheadAttention`` (packed in_proj_weight / in_proj_bias)
    -> ``models/muvla.MHA``'s q/k/v/o tree."""
    sd = _strip(sd, prefix)
    w, b = sd["in_proj_weight"], sd["in_proj_bias"]  # [3D, D], [3D]
    d = w.shape[1]
    parts = {n: {"w": w[i * d:(i + 1) * d].t(), "b": b[i * d:(i + 1) * d]}
             for i, n in enumerate(("q", "k", "v"))}
    return {**parts, "o": _lin(sd, "out_proj")}


def _ln(sd: dict, name: str) -> dict:
    return {"w": sd[f"{name}.weight"], "b": sd[f"{name}.bias"]}


def convert_muvla_fuser(sd: dict, prefix: str = "model.fuser.") -> dict:
    """CrossFuseReduce (its forward uses the cross-attention and the
    residual LayerNorm alone) -> ``models/muvla.Fuser``'s tree."""
    sd = _strip(sd, prefix)
    return {"attn": _convert_torch_mha(sd, "cross_attn."), "ln": _ln(sd, "ln")}


def convert_muvla_qformer(sd: dict, prefix: str = "model.history_qformer.") -> dict:
    """SimpleQFormer -> ``models/muvla.QFormer``'s tree."""
    sd = _strip(sd, prefix)
    return {"queries": sd["query_embeddings"], "input_proj": _lin(sd, "input_proj"),
            "attn": _convert_torch_mha(sd, "attn."), "ln": _ln(sd, "norm")}


def convert_muvla(sd: dict, cfg) -> dict:
    """DB-MUVLA checkpoint -> MUVLA params: the LLM, the map tower
    (``model.mm_vision_tower``), the observation tower
    (``model.obs_vision_tower``), the projector, the fuser, the history
    QFormer and the reward head."""
    llm = attach_lm_head(convert_llm(sd, cfg.vlm.llm, prefix="model.llm."), sd, cfg.vlm.llm)
    obs_prefix = "model.obs_vision_tower.vision_tower.vision_model."
    return {"llm": llm, "vit": convert_vit(sd, cfg.vlm.vit, prefix=VIT_PREFIX),
            "obs_vit": convert_vit(sd, cfg.obs_vit, prefix=obs_prefix),
            "projector": convert_projector(sd, cfg.vlm.projector_type, prefix="model.mm_projector."),
            "fuser": convert_muvla_fuser(sd), "qformer": convert_muvla_qformer(sd),
            "reward_head": {"w": sd["reward_head.weight"].t()}}


def load_release_checkpoint(model, path: str, convert_fn, cfg) -> dict:
    """Fill ``model`` from a released checkpoint: its tensors are read onto
    the model's device in their stored dtype, converted by ``convert_fn``
    (``convert_cogact`` / ``convert_flow_vla`` / ``convert_oft`` / ``convert_memvla`` /
    ``convert_muvla``) and copied into the
    parameters, each cast to its parameter's dtype (utils/bridge.py).
    Returns {"load_s": seconds reading the files onto the device,
    "convert_s": seconds converting and copying}."""
    import time

    from dexbotic_tpu_torch.utils.bridge import load_jax_params

    device = next(model.parameters()).device

    def now():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    t0 = now()
    sd = load_torch_state_dict(path, device)
    t1 = now()
    load_jax_params(model, convert_fn(sd, cfg))
    return {"load_s": t1 - t0, "convert_s": now() - t1}
