"""Replay a released Dexbotic checkpoint through the PyTorch port, on the GPU.

Twin of script/replay_checkpoint.py for ``dexbotic_tpu_torch``: build the
exp of the policy from its LIBERO recipe (dims from the checkpoint's
``config.json`` where it has them), read the checkpoint's tensors onto the
card in their stored dtype, convert them (``utils/convert.py``) into the
serving model, run one frame with injected noise (a standard normal draw of
``RandomState(0)``, as the JAX script) and print the normalised chunk and,
with a ``norm_stats.json`` beside the weights, the denormalised one.

    python script/replay_checkpoint_torch.py --checkpoint /path/to/DB-CogACT-7B
    python script/replay_checkpoint_torch.py --checkpoint DIR --policy pi0 \\
        --image frame.png --prompt 'pick up the cube' --quantize int8
    python script/replay_checkpoint_torch.py --checkpoint /path/to/DB-OFT --policy oft

Without ``--image`` the frame is a seeded random 480x640 image.  Not ported:
the JAX script's ``--compare-torch`` (it runs the reference's own torch code).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

DEFAULT_PROMPT = "What action should the robot take to put both moka pots on the stove?"
POLICIES = ("cogact", "pi0", "pi05", "dm0", "oft", "oft_discrete")


def load_image(path: str | None) -> np.ndarray:
    """RGB uint8 [H, W, 3] of ``path``, or a seeded random 480x640 frame."""
    if path is None:
        return np.random.default_rng(0).integers(0, 256, (480, 640, 3), dtype=np.uint8)
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def read_hf_config(ckpt: str) -> dict:
    p = os.path.join(ckpt, "config.json")
    if not os.path.exists(p):
        return {}
    with open(p) as f:
        return json.load(f)


def build_exp(policy: str, ckpt: str, device: str = "cuda"):
    """The policy's LIBERO exp (the port's recipe twin), its model dims taken
    from the checkpoint's config.json where they differ."""
    from dexbotic_tpu_torch.playground.benchmarks.libero import (libero_cogact, libero_dm0,
                                                                 libero_oft, libero_oft_discrete,
                                                                 libero_pi0, libero_pi05)

    exp = {"cogact": libero_cogact.LiberoCogActExp, "pi0": libero_pi0.LiberoPi0Exp,
           "pi05": libero_pi05.LiberoPi05Exp, "dm0": libero_dm0.LiberoDM0Exp,
           "oft": libero_oft.LiberoOFTExp,
           "oft_discrete": libero_oft_discrete.LiberoOFTDiscreteExp}[policy]()
    exp.device = device
    hf = read_hf_config(ckpt)
    m = exp.model
    for key in ("action_dim", "chunk_size", "action_model_type", "use_proprio", "proprio_dim"):
        if key in hf and hasattr(m, key):
            m = dataclasses.replace(m, **{key: hf[key]})
    exp.model = dataclasses.replace(m, model_name_or_path=ckpt)
    return exp


def load_converted(exp) -> tuple:
    """(cfg, serving model, norm stats, {"load_s", "convert_s"}) of the exp's
    release, through the exp's own ``load_for_inference``: the serving model
    laid out in its dtypes (bf16 matrices, fp32 vectors), the checkpoint's
    tensors read onto its device, converted and copied in, then quantized if
    the exp asks for it."""
    cfg, model, norms = exp.load_for_inference()
    return cfg, model, norms, model.checkpoint_times


def replay_noise(cfg, device) -> torch.Tensor:
    draw = np.random.RandomState(0).standard_normal((1, cfg.chunk_size, cfg.action_dim))
    return torch.from_numpy(draw).float().to(device)


@torch.no_grad()
def replay_cogact(exp, cfg, model, norms, image: np.ndarray, prompt: str, noise=None):
    """(normalised chunk [chunk, dim], denormalised chunk or None) of one frame."""
    from dexbotic_tpu_torch.exp.serve import prepare_cogact_inputs
    from dexbotic_tpu_torch.models.cogact import cogact_inference_action, denorm_actions

    ids, valid, imgs = prepare_cogact_inputs(exp, cfg, exp.tokenizer.build_tokenizer(), [image],
                                             prompt, exp.device)
    noise = replay_noise(cfg, exp.device) if noise is None else noise
    chunk = cogact_inference_action(model, cfg, ids, valid, imgs, noise=noise)[0]
    chunk = chunk.float().cpu().numpy()
    return chunk, (denorm_actions(chunk, norms["min"], norms["max"]) if norms else None)


@torch.no_grad()
def replay_flow(exp, cfg, model, norms, image: np.ndarray, prompt: str, state=None, noise=None):
    """(normalised chunk, denormalised chunk or None) of one view and a state
    (zeros by default), the other views masked, as ``Pi0Exp.inference_single``."""
    from dexbotic_tpu_torch.data.image_processing import preprocess_image
    from dexbotic_tpu_torch.exp.serve import ServingStats
    from dexbotic_tpu_torch.models.flow_vla import flow_vla_inference_action

    dev = torch.device(exp.device)
    out = exp.build_tokenization(exp.tokenizer.build_tokenizer())(
        conversations=[{"from": "human", "value": prompt}])
    ids = torch.tensor(np.asarray(out["input_ids"], np.int32)[None], device=dev)
    proc = exp.data.build_image_processor()
    imgs = np.zeros((1, exp.data.num_images, proc.size, proc.size, 3), np.float32)
    imgs[0, 0] = preprocess_image(image, proc)
    masks = np.zeros((1, exp.data.num_images), np.int32)
    masks[0, 0] = 1
    s = np.zeros((1, cfg.action_dim), np.float32)
    if state is not None:
        vals = np.asarray(state, np.float32).ravel()
        s[0, : len(vals)] = vals
    mapping = norms
    if norms is not None and not isinstance(norms.get("action"), dict):
        mapping = {"action": norms.get("default", norms)}
    stats = ServingStats(mapping, exp.action.use_quantiles)
    noise = replay_noise(cfg, dev) if noise is None else noise
    chunk = flow_vla_inference_action(
        model, cfg, ids, (ids != 0).to(torch.int32), torch.from_numpy(imgs).to(dev),
        torch.from_numpy(masks).to(dev), torch.from_numpy(stats.normalize("state", s)).to(dev),
        noise=noise)[0].float().cpu().numpy()
    den = stats.denormalize("action", chunk.astype(np.float64)) if stats.has("action") else None
    return chunk, den


@torch.no_grad()
def replay_oft(exp, cfg, model, norms, image: np.ndarray, prompt: str, state=None, noise=None):
    """(normalised chunk, denormalised chunk or None) of one frame and, with
    proprio, a state (zeros by default); the noise is read by the Diffusion
    head only."""
    from dexbotic_tpu_torch.exp.serve import prepare_cogact_inputs
    from dexbotic_tpu_torch.models.cogact import denorm_actions
    from dexbotic_tpu_torch.models.oft import oft_inference_action

    ids, valid, imgs = prepare_cogact_inputs(exp, cfg, exp.tokenizer.build_tokenizer(), [image],
                                             prompt, exp.device)
    states = None
    if cfg.use_proprio:
        states = torch.zeros((1, cfg.proprio_dim), device=exp.device)
        if state is not None:
            vals = torch.as_tensor(np.asarray(state, np.float32).ravel()[: cfg.proprio_dim])
            states[0, : len(vals)] = vals.to(exp.device)
    noise = replay_noise(cfg, exp.device) if noise is None else noise
    chunk = oft_inference_action(model, cfg, ids, valid, imgs, states=states,
                                 noise=noise)[0].float().cpu().numpy()
    return chunk, (denorm_actions(chunk, norms["min"], norms["max"]) if norms else None)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", required=True, help="released checkpoint dir or file")
    ap.add_argument("--policy", default="cogact", choices=POLICIES)
    ap.add_argument("--image", default=None)
    ap.add_argument("--prompt", default=DEFAULT_PROMPT)
    ap.add_argument("--quantize", default="", choices=["", "int8", "w8a8"],
                    help="serve the converted weights quantized (inference_quantize)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    exp = build_exp(args.policy, args.checkpoint, args.device)
    exp.inference_quantize = args.quantize
    cfg, model, norms, times = load_converted(exp)
    print(f"loaded in {times['load_s']:.2f} s, converted in {times['convert_s']:.2f} s")
    replay = (replay_cogact if args.policy == "cogact" else
              replay_oft if args.policy.startswith("oft") else replay_flow)
    chunk, den = replay(exp, cfg, model, norms, load_image(args.image), args.prompt)
    print("normalized chunk:")
    print(np.array2string(chunk, precision=5))
    if den is not None:
        print("denormalized actions:")
        print(np.array2string(den, precision=5))


if __name__ == "__main__":
    main()
