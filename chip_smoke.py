"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, any failure exits non-zero without a result line:
  1. card, power limit and versions; TF32 off for the reference comparisons;
  2. build the hand-written kernels from ``dexbotic_tpu_torch/csrc``;
  3. K1 (flash-attention forward) against its plain version at the served
     prompt's shape, the training step's shape, three more and OFT's three
     (the prompt's pads mid-row, before the appended segment: the joint
     1 x 944 rows, the cached 113 x 945 segment, training's 8 x 2105), the
     shapes OFT's server and MemVLA's prefill give it, GRPO's 8 x 648
     rollout and update rows, MemVLA training's 2 x 2048 (K3 there too, in
     phase 6), and NaVILA's: the 2195-token prefill against its 2227-column
     bf16 cache, one decode row against that cache, and packed training
     rows of 4096 with two segments each at 2 and 4 rows (K3 too), with the
     share of dead tiles; the decode engine's (phase 14): admission
     prefills at B = 1..8 (1..4 for MUVLA), chunks at B = slots with parked
     and empty slots, one query row a slot at per-slot depths, generate's
     prefill and decode rows, and Discrete VLA's and MUVLA's training rows
     (K3 too), and hybrid CogACT's mixed rows (phase 15d: a robot row and a
     VQA row of 2048; K3 too); a query row that sees no key must come out
     exactly 0;
  3b. K1 at head_dim 256 against its plain version at pi0's prefix (8 query
     heads on 1 kv head, the text's padded tail masked) and its suffix
     against the cached prefix: 1 x 816 and 51 x 867 (inference_single),
     1 x 832 and 51 x 883 (a served request), 2 x 832 and 2 x 51 x 883 (the
     batch_size=2 request, whose prefix takes 128-row blocks), and pi0's
     training rows (phase 8: 4 x 867, prefix, state token and actions in
     one bidirectional-prefix call); then pi0.5's 50-row suffix against its
     832-token prefix (8/1 heads of 256), DM0's causal 1 x 896 prefix (16/8
     heads of 128: GQA groups of 2, a group a token), its 50-row suffix and
     DM0-Prog's 51-row one against it, and the LIBERO twins' training rows,
     4 x 978 (pi0.5) and 4 x 918 (DM0; K3 at both too);
  4. K2 (fused DiT sampler) against its plain version at DiT-B width, with
     bf16 weights, then (4b) with int8 block weights: B=1, 2 and 8 (the
     8-frame micro-batch, 16 rows with CFG), DDIM-10 and DPM-5, CFG 1.5,
     with the plan's N tiles, items and partial MB of every product;
  4c. K4 (int8-weight matmul) against its plain version (the dequantize
     formulation), bf16 and fp32 activations, at the served shapes (z_embed,
     t_mlp), LLaMA-7B's at 1-64 rows and an int8 request's prefill products
     (CLIP-L/336 at 577 rows, the projector at 576, LLaMA-2-7B at 832 and
     1664), and with fp32 activations pi0's int8 prefill (Gemma-2B at 832
     rows, SigLIP so400m/224 and the projector at 768), and int8 OFT's
     (the joint 944 rows and the DDIM segment's 113 at LLaMA's widths, the
     noisy-action projector and lm_head at 112, the MLPResNet at 16 fp32
     rows from K = 28672), and int8 MemVLA's (the SE bottleneck, the
     bank's two roles, the per-token embedder and the DiT with its memory
     keys and values, fp32 and bf16 activations), and int8 Discrete VLA's
     and MUVLA's (phase 14e/14f: the engine's decode at 4 and 8 rows and
     generate's at 1, each with the lm_head, generate's 855- and 959-row
     prefills in bf16; MUVLA's 960-row admission, two frames' tower and
     projector, MUVLA's fuse in fp32); two calls must agree
     bit for bit, and where the dispatch rule gives K4 the shape it must not
     be slower than the plain version;
  5. the serving slice: CogACT-7B (LLaMA-2-7B + CLIP-L/336 + DiT-B, seeded
     random weights, bf16) served over HTTP by the port's CogActServer:
     single frames, a batch_size=2 request and an 8-frame one (one K2 launch
     for its 16 sampler rows), with both kernels' launch counts read around
     the served requests, then the same frame, and the 8-frame batch,
     through the plain path (kernels off) for a cosine check, and the device
     path by part at 1 and 8 frames;
  5d. the same model served with on-device preprocessing
     (CogActServer(fuse_preprocess=True): raw uint8 frames uploaded, the BGR
     flip, pad, resize and normalisation on the card) beside the host path:
     the same 480x640 PNG, 6 single frames and 4 8-frame requests a route;
     the two routes' pixels within 2 uint8 quanta, their chunks on the same
     noise at cosine >= 0.99, fused_calls equal to the requests the fused
     server served, K1 and K2 counted on the fused route, p50/p90 of both
     routes and the host preprocessing the fused route removes; then 16
     actions through the robot client (dexbotic_tpu_torch/client.py), which
     must take 2 requests;
  5e. the same model exported under the reference's key names (Dexbotic's
     HF layout, sharded .safetensors in _checkpoints/, deleted after) by
     this file's writer, then read onto the card and converted by the
     exp's own release path (``load_for_inference`` with
     ``model_name_or_path`` the release; the exp built by
     script/replay_checkpoint_torch.py from the LIBERO CogACT recipe, dims
     from config.json): every parameter bit for bit, and the chunk on phase
     5's frame and noise equal to phase 5's; prints the file bytes, load and
     convert seconds, the host's peak RSS and the device memory the load
     added (fails above the model's and the files' bytes + 1 GiB);
  5b. the same model quantized (inference_quantize="w8a8": weight-only int8,
     int8 activations from 2048 rows) served over HTTP: single frames, a
     batch_size=2 request and an 8-frame one (one K2 launch), with the K1,
     K2 and K4 launch counts read around them; one more single frame, whose K4 launches must
     equal the quantized products the dispatch rule gives K4, counted from
     the model (and seen by forward hooks); then the kernel-vs-plain cosine
     on the int8 weights, the int8 chunk's cosine to phase 5's bf16 chunk
     (both >= 0.99) and the device path by part (tower + projector, prefill,
     sampler) beside phase 5's; after its timed single frames (so that their
     p50 and p90 hold no dump) the server dumps every request it answers
     (``save_image_dir``, a temp dir): one resp_*.json and one frame file a
     posted frame each, the bytes as posted and the result as answered, the
     dumps' host time printed beside the card;
  5c. pi0 at full width (SigLIP so400m/224 + Gemma-2B + the Gemma-300M
     expert, seeded random bf16 weights, fp32 activations and KV cache as
     in the JAX package, K1 fed bf16) served over HTTP by the port's
     FlowVLAServer: 6 requests of 3 views and a state, one of 1 view and a
     batch_size=2 one, with K1's launches (18 layers x (prefill + 10 Euler
     steps) a device call) and the plain attention calls on CUDA (must be 0)
     read around them; then one request through the kernel path and the
     plain path (attn_impl="xla": fp32 throughout) on the same noise for a
     cosine check, the device path by part (``part_calls`` of
     script/profile_pi0_torch.py) and K1's host time a call;
  5f. that pi0 exported and replayed as in 5e (convert_flow_vla; bit for
     bit, the same chunk), then served with int8 weights
     (inference_quantize="int8"): K4's launches a request must equal the
     products the dispatch rule gives it (counted from the model and by
     forward hooks), K1 launches 198 a request and no attention call takes
     the plain path on CUDA; every shape K4 takes there is one phase 4c
     held against its plain version; the same request with K4 and with the
     dequantize formulation (K4 off) on the same noise, max |delta| <=
     PI0_INT8_K4_BOUND; the chunk's cosine to the bf16 chunk on the same
     noise >= 0.99; p50 and weight bytes beside bf16's;
  5g. OFT-7B (OFTModelConfig's default: LLaMA-2-7B + CLIP-L/336 +
     mlp2x_gelu, seeded random bf16 weights) built once, its head swapped
     for L1 (chunk 16), the LIBERO recipe's L1 (chunk 8, a proprio token and
     the client's state), Diffusion (DDIM-10 over a 113-token segment
     against the 832-token prompt cache) and Discrete (lm_head's last 255
     vocab slots), each served through OFTServer's /process_frame: 8 single
     frames after a warm-up and a batch_size=2 request (L1: also 4
     concurrent frames, micro-batched), K1 launching 32 times a request (352
     for Diffusion) and no attention call taking the plain path on CUDA (the
     micro-batched server dumps the requests it coalesced, held as 5b's); the
     chunk through the kernel path and the plain path on the same weights
     and noise (cosine >= 0.99; Discrete: the bins agree on >= 99 %); p50,
     p90 and the device call by part (tower, decoder, head or DDIM) with the
     device's idle share;
  5h. that OFT-7B with inference_quantize="w8a8", the L1, Diffusion and
     Discrete routes served: K4's launches a request equal the products the
     dispatch rule gives it (counted from the model and by forward hooks),
     every shape K4 takes is one phase 4c holds, K1 as in 5g, no plain
     attention call; the chunk's cosine to 5g's bf16 chunk on the same
     inputs and noise >= 0.99 (Discrete: the bin logits'), weight bytes;
  6. K3 (flash-attention backward) against its plain version, gradients of
     sum(out * dO) through FlashAttention: at pi0's training shape first (the
     LIBERO recipe's micro-batch: B=4, 867 tokens, 8 query heads on 1 kv head
     of 256), then at K1's shapes, CogACT training's (B=8, S=2048, 32 heads
     of 128) first, OFT's last; the plain version gets K3's own inputs, the
     out and lse K1 saved; two K3 calls must give bitwise-equal gradients
     (K1's determinism is checked there too);
  7. the training slice, CogACT-7B on the LIBERO recipe with a frozen LLM
     (rows padded to the recipe's 2048 tokens), on a synthetic Dexdata suite
     of 480x640 frames written to a temp dir:
     (a) one optimizer step (micro-batch 2) through the kernel path and the
     plain path (attn_impl="xla") on the same weights, batch and injected
     diffusion draws, compared on loss, grad_norm and the cosine of the
     projector's and the DiT's gradients; (b) three steps (micro-batch 8,
     accumulation 2) through CogActExp.train(), with K1/K3 launch counts read
     around them, a finite loss at each step and checkpoint-3 holding
     norm_stats.json; prints the step time, samples/s and peak memory;
     (c) the same recipe through CogActExp.train() on the mesh path
     (parallel/): a process group of one over NCCL made by
     multihost.maybe_initialize, a 1 x 1 ('data', 'model') mesh whose leaves
     the FSDP rule replicates (no FSDP2 group at data size 1, as in JAX),
     7b's batches replayed (its augmentations draw fresh entropy) under
     7b's schedule (max_steps 3), stopped after step 2: steps 1 and 2's loss,
     action_loss and grad_norm within rel 1e-5 of 7b's, K3 >= 32 x 2 x 2
     launches, the gathered checkpoint-2 with 7b's keys, shapes and dtypes;
     prints the step time and peak beside 7b's; the group is destroyed
     after, so the later phases run the one-device path;
  8. the pi0 training slice: pi0 at full width and depth (Pi0Exp's default,
     3.238B parameters) on the LIBERO pi0 recipe (3 views, the text padded to
     48 tokens, remat, no freeze) over a synthetic 3-view Dexdata suite with
     pi0-format statistics: (a) one optimizer step (micro-batch 2) through the
     kernel path and the plain path (attn_impl="xla" on the decoder and the
     expert) on the same weights, batch, noise and flow times, compared on
     loss, grad_norm and the gradient cosine of the LLM, the expert and the
     action projections, K3 counted on both paths; (b) two steps
     (micro-batch 4, accumulation 4) through Pi0Exp.train() with the K1/K3
     launches and plain CUDA attention calls counted, a finite loss at each
     step, checkpoint-2 holding norm_stats.json and a peak below 80 GiB;
     prints the step time, samples/s and peak memory;
  9. the OFT training slice: OFT-7B on the LIBERO OFT recipe (L1, chunk 8,
     proprio, remat) with a frozen LLM and the suite's 7-dof states as the
     proprio input, rows of 2048 + 57 tokens: (a) one step (micro-batch 2),
     kernel path vs plain path as in 7a (the projector's, the tower's and
     the head's gradients); (b) three steps of micro-batch 8 through
     OFTExp.train() with 4 forked decode processes, then the same in line:
     K1/K3 launches, no plain attention call, the step time, samples/s,
     peak memory and the seconds a step waited on its batch;
  10. GRPO post-training (SimpleVLA-RL) of the LIBERO OFT-Discrete actor
     (LLaMA-2-7B and CLIP-L/336 widths, chunk 8 x 7 bins, temperature 1.6)
     on 8 mock envs: (a) one GRPOUpdater micro-step at RL_LAYERS of 32
     decoder layers in fp32 on a rollout batch, kernel path vs plain bf16
     path vs an fp32 witness, each on the rollout's log-probs recomputed on
     the path (loss, pg_loss, entropy, grad_norm, gradient cosine; the
     update must move the fp32 weights); (b) train_rl() end to
     end at that depth, one step of schedule "random" and one of "epoch",
     with each step's gen / filter / update seconds, rollouts, chunks and
     peak, K1/K3 launches and shapes around it and the metrics' keys held
     to the JAX loop's; (c) the 32-layer bf16 actor's chunk call at B=8
     through K1 against the plain path (bin logits, argmax bins against an
     fp32 witness, the drawn bins' log-probs), ms a chunk;
  11. MemVLA-7B (CogACT-7B + an SE bottleneck, a memory bank of 16 with ToMe
     consolidation, DiT-B with memory cross-attention; seeded bf16
     weights) served over HTTP by MemVLAServer: (a) an episode of 18
     frames and the first frame of a new one (episode_first_frame), the
     bank's count after each request, K1 launches a request, no K2 launch
     and no plain attention call, every chunk's cosine between the kernel
     path and the plain path on the same noise, the new episode's first
     chunk equal to the first episode's, p50/p90 and the device call by
     part; (b) the same model with inference_quantize="w8a8": K4's launches
     a request against the forward hooks, every K4 shape among 4c's, the
     weight bytes and the chunk's cosine to bf16's;
  12. MemVLA-7B trained (the LIBERO twin, parallel_stream, the LLM frozen,
     on a synthetic suite of 8 episodes of 17 frames): (a) one step at
     micro-batch 2 in fp32 on the bank the first two batches filled: the
     kernel path, the plain path (K1's plain version on the same bf16 q, k,
     v) and bf16 weights against an fp32 witness (loss, grad_norm, the
     gradient 1-cosine of the projector, the DiT and the bank's modules),
     10a's rule; then one 'stream' step against the single shared bank;
     (b) two steps of MemVLAExp.train() at the recipe's micro-batch 8:
     each row's bank count after each step (one more, 1 at an episode
     start), K1/K3 launches and shapes, no K2, K4 or plain call, the peak;
  13. NaVILA-7B (the example recipe: LLaMA-2-7B + SigLIP-so400m/384 +
     mlp_downsample, 8 frames of 196 tokens): (a) served by NaVILAServer
     built by hand, bf16, greedy, 32 new tokens: frames with
     run_model=False (reply []), model requests (parse_nav_action's ints),
     a reset; K1 launches a request and shapes, no K2, K3, K4 or plain
     call; one request's decode teacher-forced through the plain path
     (logit cosine >= 0.999 a step, argmax flips only across 10c's
     near-ties); p50/p90 and the device call by part; (b) one packed step
     (4 samples in 2 rows of 4096, soft CE over the digits) on (a)'s
     weights in fp32, held as 12a, and the packed loss against navila_loss
     on the same samples unpacked; (c) two packed steps of
     NaVILAExp.train() at 4 rows of 4096 (remat, the LLM frozen): step
     time, tokens/s, pack fill, dead-tile share, peak, K1/K3 launches;
     (e) one step of (c)'s recipe on (b)'s weights (bf16) through
     navila_packed_loss_cp on a ('data', 'model', 'seq') = (1, 1, 1) mesh
     over a process group of one (NCCL): the ring code, one K1 hop a layer
     call, held to navila_packed_loss on the same batch (loss and grad norm
     within rel 1e-5; K1 = ring hops, K3 a layer); (f) the ring's hops at
     NaVILA-7B's layer shape (4 packed rows of 4096, 32 heads of 128) in 4
     blocks of 1024 and 2 of 2048, each rank's hops run as that rank would
     in one process (parallel/ring.simulate): out, lse, dq, dk, dv on the
     valid rows against the fp32 plain version over the whole sequence,
     each within 2x the whole-sequence call's error + 1e-3; each hop's K1
     and K3 time, a rank's hops summed against one whole-sequence call,
     the share of dead hops, and K1/K3 rows at the diagonal hop.

  14. the continuous-batching decode engine (exp/decode_engine.py): (a)
     Discrete VLA-7B (4 of 32 decoder layers, max_retries=1) served by
     DiscreteVLAServer over HTTP with 8 slots (one-shot admissions), 8
     clients x 1 request, every text unparsed and retried by sampling:
     every request's engine tokens equal to generate's or first differing
     at a near-tie (13a's rule), ticks that served several slots, K1
     counted and its shapes among phase 3's, no K2, K3, K4 or plain call;
     p50/p90, tokens/s, live slots and ms a tick, the largest gap between
     ticks around an admission, a full tick's idle share, the parsed share;
     (b) one step kernel vs plain vs fp32 witness on (a)'s weights (10a's
     rule), then two steps of DiscreteVLAExp.train() at 8 x 2048, all 32
     layers, the LLM frozen; (c) inside 13a, four NaVILA sessions on one
     shared engine (4 slots, max_prompt 2240, chunks of 512), each
     session's tokens held to its own requests without the engine; (d)
     MUVLA-7B (a map view + 4 observation views) served by MUVLAServer
     without and with the engine (4 clients), then one muvla_loss step with
     a reward in fp32 (10a's rule); (e) Discrete VLA-7B at all 32 layers
     served by DiscreteVLAServer through the engine (8 slots,
     prefill_chunk=512, 8 clients x 1 request, a decode that always
     parses) in bf16, then quantized in place by the exp ("int8", then
     "w8a8"), where one more request decodes with the exp's tokenizer, does
     not parse and takes the fused retries (its greedy retry equal to
     generate alone's tokens): the quantized products' routes (K4, the dequantize
     formulation, W8A8) from forward hooks equal to the package's counts
     and to the dispatch rule's from the model, the engine's admissions
     and ticks; K4 and K1 shapes among phases 4c's and 3's; no K2, K3 or
     plain call; the engine's tokens against generate alone by the
     near-tie rule, its bound from one decode step of the 8 prompts held
     by 10c's rule against an fp32 witness of the (dequantized) weights;
     p50/p90, ms a tick, a traced tick by part (K4, K1, the rest) with the
     idle share, weight bytes a decode step, peak memory, the tokens'
     agreement with bf16's; (f) MUVLA-7B with (d)'s seeded weights built
     with inference_quantize="int8", then "w8a8", through the engine (4
     clients): (e)'s checks and readings, agreement with (d)'s tokens.
  15. pi0.5, DM0, DM0-Prog and hybrid CogACT at full width, and the
     success-rate harness: (a) pi0.5 (Pi05Exp: SigLIP so400m/224 + Gemma-2B
     + the Gemma-300M adaRMS expert) and (b) DM0 (DM0Exp: Qwen3-1.7B + the
     Qwen3-0.6B expert, qk-norm) served by FlowVLAServer with quantile
     statistics, bf16 weights and fp32 activations: K1's launches (18 and
     28 layers x 11 a request) and shapes, no plain attention call, the
     adaRMS condition in fp32, the chunk of the kernel path against the
     plain path on the same noise (cosine >= 0.99), p50/p90 and the device
     call by part; then DM0-Prog (DM0's model and two seeded progress
     projections) through flow_vla_inference_action(progress=...), its
     chunk and end-progress held likewise; (c) the LIBERO pi0.5 and DM0
     twins trained in full: one step at micro-batch 4 in fp32, kernel path
     vs plain path vs bf16 weights against an fp32 witness (10a's rule),
     then two steps at 4 x 4 through exp.train() (K3 layers x 4 a step, K1
     twice that, the shapes 3b and 6 hold, the peak); (d) one
     HybridCogActExp step on a mixed batch (a robot row, a VQA row), fp32,
     the LLM and tower frozen, the text and action losses, 10a's rule; (e)
     the port's playground/eval_server.evaluate() with the mock env against
     phase 5's server (before it is freed): the report must equal the JAX
     harness's for the same arguments, with 32 K1 launches and 1 K2 launch
     a request.
  16. the parallel layer's MoE and pipeline at LLaMA-2-7B's layer width,
     one rank an axis: (a) an MoE decoder (2 layers, 8 experts, top-2,
     capacity 2.0, bf16) on 2 x 2048 causal rows, mot_forward(want_aux=True)
     forward and backward through K1 and K3 against the plain attention
     path (cosines >= 0.999, the balance loss within 1e-3), the dropped
     share, one layer's expert FFN time against K1's and K3's; (b) the
     GPipe pipeline at ('stage', 'data') = (1, 1) over a process group of
     one, n_micro 4, a 4-layer decoder (fp32) on 4 x 2048: the loss on
     fp32 embeddings and its grad norm within rel 1e-5 of the unpipelined
     loss over the whole batch, every gradient within 1e-5 of it over the
     same micro-batches, K1 and K3 16 each; the plain fp32 path's whole
     against micro-batched gradients within 1e-5, K1 (at one block height)
     and K3 bit for bit whole and micro-batched; pipeline_causal_lm_loss
     (bf16 embeddings) once, finite, K1 and K3 16 each.

Error rule for a kernel: its max error against the plain version run in
fp32 on the same bf16 inputs must not exceed 2x the plain bf16 version's
error against that reference + 1e-3 (K4: the reference in fp64, for bf16 and
fp32 activations).  Each kernel's bound is the larger of the bytes its
function must move (each input read once, each output written once) over
3.35 TB/s and its operations over the H100 SXM's peak for their type (989
TFLOP/s bf16; 495 TF32 for K4's fp32 activations); the library time is one
PyTorch call computing the same function (SDPA for K1 and K3, a bf16 matmul
on the dequantized weight for K4), timed here and used nowhere in the port.
``device_ms`` (K1, K3, K4, and K2 at B=1, 2 and 8) is the kernels' own
device time per call from ``torch.profiler`` (CUDA events of calls queued
behind device work where three profiling sessions see none of its kernels),
beside ``ms`` (CUDA events around the Python call).  Phase 2 lists the
registers and spills of every K1, K3, K4 and K2 instance from nvcc's
``-Xptxas -v`` (a spill fails) and the HGMMA instructions of every K2
instance from the library's SASS (``cuobjdump``, run beside phase 7,
whose steps take seconds: beside no kernel's timing; a bf16 instance
without one fails).
Past phase 8, exp.train() writes no checkpoint (unwritten_checkpoints: the
Trainer's save is called and records its step; 7b, 7c and 8b write theirs
and read them back).
Phases 5d-5h and 9-15 print their numbers as one JSON line (``{"phases": ...}``);
each phase's seconds are printed after it ("[phase_...: s; s in all]").
The last two lines printed are the kernels' JSON summary and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import gc
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types
import urllib.error
import urllib.request
import warnings

import numpy as np
import torch

REPS = 20
PART_REPS = 3  # a device call's parts (wall_ms): medians of 3 calls after one
LIB_REPS = 5  # SDPA's time beside K1's and K3's (cuDNN with a mask: ~40 ms of host a call)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 495e12}  # dense tensor-core bf16; TF32

# The recipe keeps TokenizerConfig's model_max_length, 2048, and the collator
# pads every training row to it.  A sample of the synthetic suite is 576 image
# tokens plus the chat template, the prompt and the 112-value action answer in
# byte-level tokens: up to TRAIN_TOKENS.
TRAIN_SEQ_LEN, TRAIN_TOKENS = 2048, 1304

# The attention cases of phases 3 and 6: (B, S, Hq, Hkv, D, right-padded tail,
# segments + a row that sees no key).  TRAIN_CASE is the shape training gives
# K1 and K3 (phase 7b); SERVE_CASE the served prompt's bucket (phase 5); the
# last two are the JAX multi-block path with GQA and a narrow GQA model.
TRAIN_CASE = (8, TRAIN_SEQ_LEN, 32, 32, 128, TRAIN_SEQ_LEN - TRAIN_TOKENS, False)
SERVE_CASE = (1, 832, 32, 32, 128, 59, False)
OTHER_CASES = [(8, 832, 32, 32, 128, 59, False), (1, 1408, 32, 8, 128, 59, True),
               (2, 832, 14, 2, 64, 59, True)]


# OFT (phases 5g, 5h and 9): phase 5's prompt is 811 tokens, served in the
# 832 bucket; the segment appended after the padded prompt is 112 action
# tokens (L1, Discrete), 113 with Diffusion's timestep token (run against the
# 832-token prompt cache), 57 for LIBERO (a proprio token and 8 x 7 actions);
# training rows are the recipe's 2048 tokens + 57.  The prompt's pads sit
# mid-row, between the prompt and the segment.  OFT_CASES: (result key, B,
# valid prompt tokens, padded prompt, segment, segment against the cache).
OFT_PROMPT_TOKENS, OFT_BUCKET = 811, 832
OFT_TRAIN_MICRO = 8  # LiberoOFTExp's per_device_batch_size (TrainerConfig's default)
OFT_CASES = [("oft_joint", 1, OFT_PROMPT_TOKENS, OFT_BUCKET, 112, False),
             ("oft_cached", 1, OFT_PROMPT_TOKENS, OFT_BUCKET, 113, True),
             ("oft_train", OFT_TRAIN_MICRO, TRAIN_TOKENS, TRAIN_SEQ_LEN, 57, False)]
# The other K1 calls of 5g and 5h, held by phase 3 alone (K3 is training's):
# LIBERO's 57-token segment, Diffusion's prefill of the prompt (its pads
# trail), and each at the batch_size=2 request's 2 rows and the 4-frame
# micro-batch's 4.  5g and 5h fail on a K1 shape that is in neither list.
OFT_SERVED_CASES = [
    (f"oft_{part}{'' if B == 1 else f'_b{B}'}", B, OFT_PROMPT_TOKENS, OFT_BUCKET, seg, cached)
    for B in (1, 2, 4)
    for part, seg, cached in (("joint", 112, False), ("libero_joint", 57, False),
                              ("prefill", 0, False), ("cached", 113, True))
    if (part, B) not in (("joint", 1), ("cached", 1))]


def oft_k1_shape(B: int, n_valid, padded: int, seg: int, cached: bool) -> tuple:
    """(B, query rows, key rows) of an OFT K1 call: OFT_CASES' fields."""
    return B, seg if cached else padded + seg, padded + seg


K1_OFT_CHECKED = {oft_k1_shape(*c) for _, *c in OFT_CASES + OFT_SERVED_CASES}

# GRPO post-training of the LIBERO OFT-Discrete actor (phases 10a-10c): each
# rollout row is a prompt of num_image_tokens + prompt_text_len = 576 + 16
# slots and the 56-slot Discrete segment (chunk 8 x 7 actions); the rollouts
# run the 8 envs' rows at once, the update micro-batches of 8.  The mock
# env's instruction fills the 16 text slots ("rl"); LIBERO's shorter ones
# leave each row's own number of pads mid-row ("rl_padded": RL_PADS).
# Phases 3 and 6 hold K1 and K3 at both; 10b and 10c fail on a K1 shape
# outside K1_RL_CHECKED.
RL_PROMPT_TOKENS, RL_SEGMENT, RL_ENVS = 576 + 16, 8 * 7, 8
RL_PADS = (0, 3, 0, 7, 1, 0, 12, 5)
RL_CASES = [("rl", RL_ENVS, RL_PROMPT_TOKENS, RL_PROMPT_TOKENS, RL_SEGMENT, False),
            ("rl_padded", RL_ENVS, tuple(RL_PROMPT_TOKENS - p for p in RL_PADS),
             RL_PROMPT_TOKENS, RL_SEGMENT, False)]
K1_RL_CHECKED = {oft_k1_shape(*c) for _, *c in RL_CASES}
# MemVLA (phase 11): phase 5's prompt (811 tokens) in its 832-token bucket,
# the pads trailing, as OFT-Diffusion's prefill: phase 3 holds it as
# "oft_prefill"; 11a and 11b fail on another K1 shape
MEMVLA_PREFILL_CASE = next(c for c in OFT_SERVED_CASES if c[0] == "oft_prefill")
K1_MEMVLA_CHECKED = {oft_k1_shape(*MEMVLA_PREFILL_CASE[1:])}


@contextlib.contextmanager
def k1_calls(shapes: set, launch_name: str = "_flash_cuda"):
    """Adds each K1 launch's (B, query rows, key rows) to ``shapes`` while
    inside (a wrapper on the launch; no device synchronisation); with
    ``launch_name="_flash_bwd_cuda"``, each K3 launch's."""
    from dexbotic_tpu_torch.ops import attention as attn

    launch = getattr(attn, launch_name)

    def recorded(q, k, *args, **kw):
        shapes.add((q.shape[0], q.shape[1], k.shape[1]))
        return launch(q, k, *args, **kw)

    setattr(attn, launch_name, recorded)
    try:
        yield shapes
    finally:
        setattr(attn, launch_name, launch)


def _launch_counts() -> dict:
    """Every kernel's launch count in this process, and the plain CUDA attention calls."""
    from dexbotic_tpu_torch.ops import quant_matmul as qm
    from dexbotic_tpu_torch.ops.attention import attention, flash_attention, flash_attention_bwd
    from dexbotic_tpu_torch.ops.dit_fused import fused_dit_sample

    return {"flash_fwd": flash_attention.launches, "flash_bwd": flash_attention_bwd.launches,
            "dit_sample": fused_dit_sample.launches, "quant_matmul": qm.quant_matmul.launches,
            "plain_cuda_calls": attention.plain_cuda_calls}


def _zero_counts() -> None:
    """Set every count of _launch_counts to 0."""
    from dexbotic_tpu_torch.ops import quant_matmul as qm
    from dexbotic_tpu_torch.ops.attention import attention, flash_attention, flash_attention_bwd
    from dexbotic_tpu_torch.ops.dit_fused import fused_dit_sample

    flash_attention.launches = flash_attention_bwd.launches = attention.plain_cuda_calls = 0
    fused_dit_sample.launches = qm.quant_matmul.launches = 0


def oft_attn_inputs(B: int, n_valid, padded: int, seg: int, cached: bool, gen):
    """(name, q, k, v, (q_grp, kv_grp, kv_valid), None) of an OFT decoder
    call (LLaMA-2: 32 heads of 128): the padded prompt then the segment,
    groups cumsum(valid); with ``cached`` the segment's queries alone against
    the prompt's cache and the segment.  ``n_valid``: the valid prompt
    tokens of every row, or a tuple of each row's."""
    dev = torch.device("cuda")
    S = padded + seg
    valid = torch.ones(B, S, dtype=torch.int32, device=dev)
    rows = n_valid if isinstance(n_valid, tuple) else (n_valid,) * B
    for b, n in enumerate(rows):
        valid[b, n:padded] = 0
    grp = torch.cumsum(valid, 1, dtype=torch.int32)
    Sq = seg if cached else S
    q = torch.randn(B, Sq, 32, 128, generator=gen, device=dev).bfloat16()
    k, v = (torch.randn(B, S, 32, 128, generator=gen, device=dev).bfloat16() for _ in range(2))
    q_grp = grp[:, padded:].contiguous() if cached else grp.clone()
    part = "cached segment" if cached else "joint rows" if seg else "prompt prefill"
    pads = tuple(padded - n for n in rows) if len(set(rows)) > 1 else padded - rows[0]
    name = (f"OFT {part} B={B} Sq={Sq} Skv={S} ({pads} pads "
            f"{'mid-row' if seg else 'trailing'}) H=32/32 D=128")
    return name, q, k, v, (q_grp, grp, valid), None


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = REPS, flush=None) -> float:
    """Median device time of one call, over ``reps`` calls after a warm-up;
    ``flush`` (untimed) runs before each, to start from a cold L2."""
    return statistics.median(times_ms(fn, reps, flush))


def times_ms(fn, reps: int = REPS, flush=None) -> list:
    """The device times of ``reps`` calls after a warm-up (see median_ms)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def device_ms(fn, kernels: tuple, reps: int = 10, sessions: int = 3,
              parts: dict | None = None) -> float:
    """The named kernels' own device time per call (``torch.profiler``,
    ``self_device_time_total``): the call's time without its host wrapper;
    ``parts`` receives each named kernel's share.  A profiling session can
    come back with no kernel record (CUPTI, once in 4c on an H100 after
    dozens of sessions in the process): it is run again, and after
    ``sessions`` empty ones the time is :func:`queued_ms`'s."""
    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = dict.fromkeys(kernels, 0.0)
        for e in prof.key_averages():
            hit = next((k for k in kernels if k in e.key), None)
            if hit is not None:
                t = getattr(e, "self_device_time_total", None)
                times[hit] += e.self_cuda_time_total if t is None else t
        total = sum(times.values())
        if total > 0:
            if parts is not None:
                parts.update({k: t / reps / 1e3 for k, t in times.items() if t})
            return total / reps / 1e3
    ms = queued_ms(fn, reps)
    print(f"    the profiler saw no device time of {kernels} in {sessions} sessions; "
          f"CUDA events of {reps} queued calls: {ms:.4f} ms a call")
    return ms


def queued_ms(fn, reps: int = 10) -> float:
    """Device time per call of ``reps`` back-to-back calls, CUDA events
    around them, enqueued behind a device sleep of at least twice the host's
    enqueue (at <= 2 GHz): the calls and the gaps between their kernels,
    without the host's time."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2 * reps * host_s * 2e9, 2e9)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


K1_KERNELS = ("flash_fwd_kernel", "tile_class_kernel")
K3_KERNELS = ("pre_kernel", "tile_class_kernel", "dkv_kernel", "dkv256_kernel", "dkv_sum_kernel",
              "dq_kernel", "dq256_kernel")
K2_KERNELS = ("dit_sample_kernel",)
K4_KERNELS = ("qm_kernel", "reduce_kernel", "split_kernel")


def bound(nbytes: float, ops: float, dtype=torch.bfloat16) -> tuple[float, str]:
    """(least time in ms the card could take, which of the two sets it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


@contextlib.contextmanager
def plain_int8():
    """Quantized layers take the plain dequantize formulation (K4 off) inside:
    the plain path of a kernel-vs-plain comparison."""
    from dexbotic_tpu_torch.ops import quant_matmul

    quant_matmul.KERNEL_DISPATCH = False
    try:
        yield
    finally:
        quant_matmul.KERNEL_DISPATCH = True


def plain_config(cfg):
    """``cfg`` with its decoder on the plain attention (K1 and K3 off)."""
    llm = dataclasses.replace(cfg.vlm.llm, attn_impl="xla")
    return dataclasses.replace(cfg, vlm=dataclasses.replace(cfg.vlm, llm=llm))


def sdpa(q, k, v, mask, backward: bool = False):
    """(backend name, q, k, v as [B, H, S, D] leaves, call) of
    scaled_dot_product_attention on the same inputs and mask: the first of
    flash, cuDNN, memory-efficient and math that takes them (and, with
    ``backward``, also takes their gradient)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
    gqa = q.shape[2] != k.shape[2]
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        def call(backend=backend):
            with sdpa_kernel([backend]):
                return torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=gqa)
        try:
            with torch.set_grad_enabled(backward), warnings.catch_warnings():
                warnings.simplefilter("ignore")  # the refusals of the backends tried first
                out = call()
                if backward:
                    torch.autograd.grad(out.sum(), (qt, kt, vt))
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        return backend.name, (qt, kt, vt), call
    raise RuntimeError("no SDPA backend takes these inputs")


def seg_pair(seg) -> tuple:
    """(q_seg, kv_seg) of a case's segments: one tensor for both, a pair, or None."""
    return seg if isinstance(seg, tuple) else (seg, seg)


def attn_counts(q, k, ints, seg, out_tensors) -> tuple[int, int]:
    """(bytes, live query-key pairs x query heads) of one attention call."""
    from dexbotic_tpu_torch.ops.attention import _allowed

    pairs = int(_allowed(*ints, *seg_pair(seg)).sum().item()) * q.shape[2]
    return nbytes(*ints, *seg_pair(seg), *out_tensors), pairs


def check_bound(name: str, err: float, plain_err: float, failures: list) -> None:
    bound = 2.0 * plain_err + 1e-3
    ok = err <= bound
    print(f"  {name}: kernel err {err:.6g}  plain bf16 err {plain_err:.6g}  bound {bound:.6g}  "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{name}: err {err} > bound {bound}")


def attn_inputs(case, gen):
    """(name, q, k, v, (q_grp, kv_grp, kv_valid), seg) of one attention case, bf16 on the card."""
    B, S, Hq, Hkv, D, pad, packed = case
    dev = torch.device("cuda")
    q = torch.randn(B, S, Hq, D, generator=gen, device=dev).bfloat16()
    k = torch.randn(B, S, Hkv, D, generator=gen, device=dev).bfloat16()
    v = torch.randn(B, S, Hkv, D, generator=gen, device=dev).bfloat16()
    valid = torch.ones(B, S, dtype=torch.int32, device=dev)
    valid[:, S - pad:] = 0  # right padding, as the server's buckets and the collator give
    grp = torch.cumsum(valid, 1, dtype=torch.int32)
    q_grp = grp.clone()
    seg = None
    if packed:
        seg = (torch.arange(S, device=dev) >= S // 3).int()[None].expand(B, S).contiguous()
        q_grp[:, 5] = 0  # sees no key
    name = f"B={B} S={S} H={Hq}/{Hkv} D={D}{' segments+masked row' if packed else ''}"
    return name, q, k, v, (q_grp, grp, valid), seg


def phase_flash(failures: list) -> dict:
    from dexbotic_tpu_torch.ops.attention import _allowed, flash_attention_fwd, flash_attention_ref

    print("phase 3: K1 flash_fwd vs plain")
    g = torch.Generator(device="cuda").manual_seed(1)
    worst, times = 0.0, {}
    # the main paths' shapes carry a key: the library's time and the kernels' own
    cases = [("serve" if c == SERVE_CASE else "train" if c == TRAIN_CASE else None,
              lambda c=c: attn_inputs(c, g)) for c in [SERVE_CASE, TRAIN_CASE, *OTHER_CASES]]
    cases += [(key, lambda c=c: oft_attn_inputs(*c, g)) for key, *c in OFT_CASES]
    cases += [(key, lambda c=c: oft_attn_inputs(*c, g)) for key, *c in OFT_SERVED_CASES]
    cases += [(key, lambda c=c: oft_attn_inputs(*c, g)) for key, *c in RL_CASES]
    cases += [("memvla_train", lambda: attn_inputs(MEMVLA_TRAIN_CASE, g))]
    cases += [(key, lambda c=c: navila_attn_inputs(*c, g)) for key, *c in NAVILA_CASES]
    cases += [(key, lambda kind=kind, B=B, kw=kw: engine_attn_inputs(kind, B, g, **kw))
              for key, kind, B, kw in _engine_cases()]
    cases += [("discrete_train", lambda: attn_inputs(DISCRETE_TRAIN_CASE, g)),
              ("muvla_train", lambda: attn_inputs(MUVLA_TRAIN_CASE, g)),
              ("hybrid_train", lambda: hybrid_attn_inputs(g))]
    for key, make in cases:
        name, q, k, v, (q_grp, grp, valid), seg = make()
        args = (grp, valid, None, *seg_pair(seg))
        out, lse = flash_attention_fwd(q, k, v, q_grp, *args)
        torch.cuda.synchronize()
        blind = ~_allowed(q_grp, grp, valid, *seg_pair(seg))[:, 0].any(-1)  # rows that see no key
        if blind.any() and not (out[blind] == 0).all():
            failures.append(f"{name}: a query row that sees no key is not exactly 0")
        ref, ref_lse = flash_attention_ref(q.float(), k.float(), v.float(), q_grp, *args)
        plain, _ = flash_attention_ref(q, k, v, q_grp, *args)
        err = (out.float() - ref).abs().max().item()
        plain_err = (plain.float() - ref).abs().max().item()
        live = ref_lse > -1e30
        lse_err = (lse - ref_lse)[live].abs().max().item()
        reps = REPS if key is not None else 5  # a shape no row of the kernel table reads: fewer
        ms = median_ms(lambda: flash_attention_fwd(q, k, v, q_grp, *args), reps)
        plain_ms = median_ms(lambda: flash_attention_ref(q, k, v, q_grp, *args), 5)
        check_bound(name, err, plain_err, failures)
        io_bytes, pairs = attn_counts(q, k, (q_grp, grp, valid), seg, (q, k, v, out, lse))
        bound_ms, bound_by = bound(io_bytes, 4 * q.shape[-1] * pairs)
        line = (f"    lse err {lse_err:.3g}  kernel {ms:.4f} ms  plain bf16 {plain_ms:.4f} ms  "
                f"bound {bound_ms:.4f} ms ({bound_by})")
        lib = {"library_ms": None}
        if key is not None:  # a main path's shape: the library's time
            mask = _allowed(q_grp, grp, valid, *seg_pair(seg))
            backend, _, call = sdpa(q, k, v, mask)
            with torch.no_grad():
                lib_err = (call().transpose(1, 2).float() - ref).abs().max().item()
                lib = {"library_ms": median_ms(call, LIB_REPS), "sdpa_backend": backend,
                       "device_ms": device_ms(lambda: flash_attention_fwd(q, k, v, q_grp, *args),
                                              K1_KERNELS)}
            line += (f"  kernels alone {lib['device_ms']:.4f} ms  SDPA ({backend}) "
                     f"{lib['library_ms']:.4f} ms, err {lib_err:.3g}")
        print(line)
        worst = max(worst, err)
        if key is not None:
            times[key] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                          "bound_by": bound_by, **lib}
            if key.startswith(("oft", "rl", "memvla", "navila", "discrete", "muvla", "hybrid")):
                times[key].update(max_abs_err=err, B_Sq_Skv=[q.shape[0], q.shape[1], k.shape[1]])
                if blind.any():
                    times[key]["rows_seeing_no_key"] = int(blind.sum())
            if key.startswith("navila"):
                times[key]["dead_tile_share"] = dead_tile_share(q_grp, grp, valid, seg)
                print(f"    dead tiles {times[key]['dead_tile_share']:.1%} of the call's 64 x 64 "
                      f"tiles; the bound counts the visible pairs only")
        del q, k, v, out, lse, ref, ref_lse, plain
    free_memory()
    # serving's shape, training's, then OFT's
    return {"max_abs_err": worst, **times["serve"],
            **{f"train_{key}": val for key, val in times["train"].items()},
            **{key: times[key] for key, *_ in OFT_CASES + RL_CASES}, "memvla_train": times["memvla_train"],
            **{key: times[key] for key, *_ in NAVILA_CASES},
            **{key: times[key] for key, *_ in _engine_cases() if key is not None},
            "discrete_train": times["discrete_train"], "muvla_train": times["muvla_train"],
            "hybrid_train": times["hybrid_train"],
            "oft_served": {key: times[key] for key, *_ in OFT_SERVED_CASES}}


# pi0's K1 calls (Gemma-2B and its expert: 8 query heads on 1 kv head of 256):
# a prefix of 3 views x 256 image tokens + the text, bidirectional, the text's
# padded tail masked; the 51-token suffix (state token, 50 actions) against
# that cached prefix.  PROMPT is 22 byte-level tokens: of the 48 of pi0's
# inference_single (816; 51 x 867), and of the server's 64-token bucket
# (832; 51 x 883; the batch_size=2 request's 2 x 832 takes 128-row blocks).
# Training (phase 8) gives K1 the joint rows, 816 + 51 (pi0_train_attn_inputs).
PI0_VIEWS, PI0_PROMPT_TOKENS, PI0_SUFFIX = 3 * 256, 22, 51
PI0_TRAIN_MICRO = 4  # the LIBERO pi0 recipe's per_device_batch_size
PI0_CASES = [  # (result key, B, text tokens, prefix, suffix or training rows)
    ("d256_prefix", 1, 48, "prefix"), ("d256_suffix", 1, 48, "suffix"),
    ("d256_served_prefix", 1, 64, "prefix"), ("d256_served_suffix", 1, 64, "suffix"),
    ("d256_batch2_prefix", 2, 64, "prefix"), ("d256_batch2_suffix", 2, 64, "suffix"),
    ("d256_train", PI0_TRAIN_MICRO, 48, "train")]


def pi0_attn_inputs(B: int, text: int, part: str, gen):
    """(name, q, k, v, (q_grp, kv_grp, kv_valid)) of a pi0 call: the prefix
    of ``PI0_VIEWS + text`` tokens or the suffix against it, cached."""
    dev = torch.device("cuda")
    prefix = PI0_VIEWS + text
    Sq = prefix if part == "prefix" else PI0_SUFFIX
    Skv = prefix + (0 if part == "prefix" else Sq)
    q = torch.randn(B, Sq, 8, 256, generator=gen, device=dev).bfloat16()
    k, v = (torch.randn(B, Skv, 1, 256, generator=gen, device=dev).bfloat16() for _ in range(2))
    valid = torch.ones(B, Skv, dtype=torch.int32, device=dev)
    valid[:, PI0_VIEWS + PI0_PROMPT_TOKENS: prefix] = 0
    kv_grp = torch.zeros(B, Skv, dtype=torch.int32, device=dev)
    if Skv > prefix:  # suffix groups: state token 1, action tokens 2
        kv_grp[:, prefix:] = 2
        kv_grp[:, prefix] = 1
    name = f"pi0 {part} B={B} Sq={Sq} Skv={Skv} H=8/1 D=256"
    return name, q, k, v, (kv_grp[:, Skv - Sq:].contiguous(), kv_grp, valid)


def phase_flash_flow(failures: list) -> dict:
    """K1 against its plain version at the flow VLAs' shapes: pi0's at head_dim
    256 (those of inference_single, of a served request, of the batch_size=2
    request and of a training micro-batch), then pi0.5's and DM0's
    (FLOW_CASES: the served prefix and suffix, DM0-Prog's suffix, the LIBERO
    twins' training rows), with the block rows ``fwd_rows`` picks, its time,
    its kernels' own time, its bound and SDPA's time (cuDNN with a bool
    mask, or the backend that took the inputs when cuDNN refused).  Both
    block shapes must be held at head_dim 256."""
    from dexbotic_tpu_torch.ops.attention import (
        _allowed, _sm_count, flash_attention_fwd, flash_attention_ref, fwd_rows)

    print("phase 3b: K1 flash_fwd vs plain at the flow VLAs' shapes (pi0, pi0.5, DM0, DM0-Prog)")
    g = torch.Generator(device="cuda").manual_seed(11)
    rows, block_rows = {}, set()
    cases = [(key, lambda B=B, text=text, part=part: (
        pi0_train_attn_inputs(B, g)[:5] if part == "train" else pi0_attn_inputs(B, text, part, g)))
        for key, B, text, part in PI0_CASES]
    cases += [(key, lambda c=c: flow_attn_inputs(*c, g)[:5]) for key, *c in FLOW_CASES]
    for key, make in cases:
        name, q, k, v, ints = make()
        B, Hq, D = q.shape[0], q.shape[2], q.shape[3]
        n_rows = fwd_rows(B, q.shape[1], Hq, _sm_count(0), D)
        if D == 256:
            block_rows.add(n_rows)
        out, lse = flash_attention_fwd(q, k, v, *ints)
        torch.cuda.synchronize()
        ref, _ = flash_attention_ref(q.float(), k.float(), v.float(), *ints)
        plain, _ = flash_attention_ref(q, k, v, *ints)
        err = (out.float() - ref).abs().max().item()
        check_bound(f"{name} ({n_rows}-row blocks)", err,
                    (plain.float() - ref).abs().max().item(), failures)
        ms = median_ms(lambda: flash_attention_fwd(q, k, v, *ints))
        dev_ms = device_ms(lambda: flash_attention_fwd(q, k, v, *ints), K1_KERNELS)
        plain_ms = median_ms(lambda: flash_attention_ref(q, k, v, *ints), 5)
        io_bytes, pairs = attn_counts(q, k, ints, None, (q, k, v, out, lse))
        bound_ms, bound_by = bound(io_bytes, 4 * q.shape[-1] * pairs)
        backend, _, call = sdpa(q, k, v, _allowed(*ints, None, None))
        with torch.no_grad():
            lib_err = (call().transpose(1, 2).float() - ref).abs().max().item()
        lib_ms = median_ms(call, LIB_REPS)
        note = "" if backend == "CUDNN_ATTENTION" else f" (cuDNN refused these inputs: {backend})"
        print(f"    kernel {ms:.4f} ms  kernels alone {dev_ms:.4f} ms  plain bf16 {plain_ms:.4f} ms  "
              f"bound {bound_ms:.4f} ms ({bound_by})  SDPA ({backend}) {lib_ms:.4f} ms, "
              f"err {lib_err:.3g}{note}")
        rows[key] = {"B_Sq_Skv_Hq_Hkv_D": [B, q.shape[1], k.shape[1], Hq, k.shape[2], D],
                     "block_rows": n_rows, "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": lib_ms, "sdpa_backend": backend}
        del q, k, v, out, lse, ref, plain
        free_memory()
    if block_rows != {64, 128}:
        failures.append(f"phase 3b held K1 at head_dim 256 only with {block_rows}-row blocks")
    return rows


def pi0_train_attn_inputs(B: int, gen):
    """(name, q, k, v, (q_grp, kv_grp, kv_valid), None) of pi0's training
    call (the LIBERO recipe's rows): 3 views x 256 image tokens and the text
    padded to 48, bidirectional, its tail masked, then the state token (group
    1) and 50 action tokens (group 2), 867 tokens, 8 query heads on 1 kv head
    of 256."""
    dev = torch.device("cuda")
    prefix = PI0_VIEWS + 48
    S = prefix + PI0_SUFFIX
    q = torch.randn(B, S, 8, 256, generator=gen, device=dev).bfloat16()
    k, v = (torch.randn(B, S, 1, 256, generator=gen, device=dev).bfloat16() for _ in range(2))
    valid = torch.ones(B, S, dtype=torch.int32, device=dev)
    valid[:, PI0_VIEWS + PI0_PROMPT_TOKENS: prefix] = 0
    grp = torch.zeros(B, S, dtype=torch.int32, device=dev)
    grp[:, prefix] = 1
    grp[:, prefix + 1:] = 2
    return f"pi0 training B={B} S={S} H=8/1 D=256", q, k, v, (grp.clone(), grp, valid), None


# phase 6's rows of K3 at head_dim 256 (pi0's and pi0.5's training calls): SDPA's
# backward timed over REPS calls, K3's device time printed by kernel (pre,
# tile classes, dK/dV, the partials' sum, dQ) and, beside the profiler's,
# by CUDA events of 10 queued calls (queued_ms)
K3_D256_ROWS = ("pi0_train", "pi05_train")


def phase_flash_bwd(failures: list) -> dict:
    from dexbotic_tpu_torch.ops.attention import (
        _allowed,
        flash_attention,
        flash_attention_bwd,
        flash_attention_bwd_ref,
        flash_attention_fwd,
    )

    print("phase 6: K3 flash_bwd vs plain (gradients of sum(out * dO) through FlashAttention)")
    g = torch.Generator(device="cuda").manual_seed(5)
    worst, rows = 0.0, {}
    # pi0's training shape (phase 8), then K1's cases, CogACT training's
    # (phase 7) first: those two are the main paths' shapes
    cases = [("pi0_train", lambda: pi0_train_attn_inputs(PI0_TRAIN_MICRO, g))]
    cases += [("main" if case == TRAIN_CASE else None, lambda case=case: attn_inputs(case, g))
              for case in [TRAIN_CASE, SERVE_CASE, *OTHER_CASES]]
    cases += [(key, lambda c=c: oft_attn_inputs(*c, g)) for key, *c in OFT_CASES + RL_CASES]
    cases += [("memvla_train", lambda: attn_inputs(MEMVLA_TRAIN_CASE, g))]
    cases += [(key, lambda c=c: navila_attn_inputs(*c, g)) for key, *c in NAVILA_CASES
              if c[0] == "packed"]
    cases += [("discrete_train", lambda: attn_inputs(DISCRETE_TRAIN_CASE, g)),
              ("muvla_train", lambda: attn_inputs(MUVLA_TRAIN_CASE, g))]
    cases += [(key, lambda c=c: flow_attn_inputs(*c, g)) for key, *c in FLOW_CASES
              if c[-1] == "train"]
    cases += [("hybrid_train", lambda: hybrid_attn_inputs(g))]
    for key, make in cases:
        name, q, k, v, ints, seg = make()
        q, k, v = (t.requires_grad_(True) for t in (q, k, v))
        dout = torch.randn(q.shape, generator=g, device="cuda").bfloat16()
        out = flash_attention(q, k, v, *ints, q_seg=seg, kv_seg=seg)
        out.backward(dout)
        torch.cuda.synchronize()
        got = (q.grad, k.grad, v.grad)
        with torch.no_grad():
            # K3's inputs: q, k, v, dO and the out and lse K1 saved for it (K1 is
            # deterministic, so running it again gives them back)
            out_k, lse_k = flash_attention_fwd(q, k, v, *ints, None, seg, seg)
            if not torch.equal(out_k, out):
                failures.append(f"{name}: K1 gave another output on the same inputs")
            qf, kf, vf = q.float(), k.float(), v.float()
            ref = flash_attention_bwd_ref(qf, kf, vf, *ints, out_k.float(), lse_k, dout.float(),
                                          None, seg, seg)
            plain = flash_attention_bwd_ref(q, k, v, *ints, out_k, lse_k, dout, None, seg, seg)
            for label, a, p, r in zip(("dq", "dk", "dv"), got, plain, ref):
                err = (a.float() - r).abs().max().item()
                check_bound(f"{name} {label}", err, (p.float() - r).abs().max().item(), failures)
                worst = max(worst, err)
                if not torch.isfinite(a).all():
                    failures.append(f"{name} {label}: non-finite gradient")
            if "masked row" in name and not (q.grad[:, 5] == 0).all():
                failures.append(f"{name}: a row that sees no key got a gradient")
            bwd_args = (q, k, v, *ints, out_k, lse_k, dout, None, seg, seg)
            again = flash_attention_bwd(*bwd_args)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                failures.append(f"{name}: two K3 calls gave different gradients")
            ms = median_ms(lambda: flash_attention_bwd(*bwd_args))
            plain_ms = median_ms(lambda: flash_attention_bwd_ref(*bwd_args), reps=5)
            # inputs q, k, v, out, dO, lse and the masks; outputs dq, dk, dv: 10 D
            # operations a live pair and query head (S, dP, dV, dK, dQ)
            io_bytes, pairs = attn_counts(q, k, ints, seg, (q, k, v, out_k, dout, lse_k, *got))
            bound_ms, bound_by = bound(io_bytes, 10 * q.shape[-1] * pairs)
        line = (f"    kernel {ms:.4f} ms  plain bf16 {plain_ms:.4f} ms  bound {bound_ms:.4f} ms "
                f"({bound_by})")
        if key is not None:  # a main path's shape: autograd through SDPA on the same inputs and mask
            backend, leaves, call = sdpa(q, k, v, _allowed(*ints, seg, seg), backward=True)
            lib_out = call()
            dout_t = dout.transpose(1, 2)
            # K3 at head_dim 256 against SDPA: the median of as many calls as K3's
            library_ms = median_ms(lambda: torch.autograd.grad(lib_out, leaves, dout_t,
                                                               retain_graph=True),
                                   REPS if key in K3_D256_ROWS else LIB_REPS)
            by_kernel = {}
            dev_ms = device_ms(lambda: flash_attention_bwd(*bwd_args), K3_KERNELS, parts=by_kernel)
            line += f"  kernels alone {dev_ms:.4f} ms  SDPA backward ({backend}) {library_ms:.4f} ms"
            if key in K3_D256_ROWS:  # and CUDA events of queued calls beside the profiler
                queued = queued_ms(lambda: flash_attention_bwd(*bwd_args))
                line += (f"  queued {queued:.4f} ms\n      by kernel: "
                         + "  ".join(f"{n} {t:.4f} ms" for n, t in by_kernel.items()))
            del lib_out, leaves
            rows[key] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
                         "sdpa_backend": backend}
            if key in K3_D256_ROWS:
                rows[key].update(device_ms_by_kernel=by_kernel, queued_ms=queued)
            if key in ("pi0_train", "pi05_train", "dm0_train"):
                rows[key]["B_S_Hq_Hkv_D"] = [q.shape[0], q.shape[1], q.shape[2], k.shape[2],
                                             q.shape[3]]
            if key != "main":
                rows[key]["max_abs_err"] = max((a.float() - r).abs().max().item()
                                               for a, r in zip(got, ref))
            if key.startswith(("oft", "rl", "memvla", "navila", "discrete", "muvla", "hybrid")):
                rows[key]["B_Sq_Skv"] = [q.shape[0], q.shape[1], k.shape[1]]
            if key.startswith("navila"):
                rows[key]["dead_tile_share"] = dead_tile_share(*ints, seg)
        print(line)
        del q, k, v, dout, out, got, again, ref, plain, out_k, lse_k, bwd_args
        free_memory()
    return {"max_abs_err": worst, **rows["main"], "pi0_train": rows["pi0_train"],
            **{key: rows[key] for key, *_ in OFT_CASES + RL_CASES}, "memvla_train": rows["memvla_train"],
            **{key: rows[key] for key, kind, *_ in NAVILA_CASES if kind == "packed"},
            "discrete_train": rows["discrete_train"], "muvla_train": rows["muvla_train"],
            **{key: rows[key] for key in ("pi05_train", "dm0_train", "hybrid_train")}}


def dit_bound(head, cfg, B: int, steps: int, cfg_scale: float) -> tuple[float, str]:
    """K2's bound: the head's parameters, z and the noise read once, the chunk
    written once; the operations of every step's products on the real rows
    (blocks, final projection, x embedding, attention) plus the per-call
    timestep MLP and z projection."""
    rows = (2 if cfg_scale > 1.0 else 1) * B
    S, H, A, T = cfg.seq_len, cfg.hidden_size, cfg.in_channels, cfg.chunk_size
    block = 3 * H * H + H * H + 2 * H * cfg.mlp_dim
    per_step = 2 * rows * S * block * cfg.depth + 2 * rows * T * H * A * 2 \
        + 4 * rows * S * S * H * cfg.depth
    once = 2 * steps * (cfg.freq_embed_size * H + H * H) + 2 * rows * cfg.token_size * H
    io = sum(p.numel() * p.element_size() for p in head.parameters()) \
        + 4 * B * (cfg.token_size + 2 * T * A)
    return bound(io, steps * per_step + once)


def _dit_head(seed: int):
    """DiT-B (token 4096, chunk 16, action 7) with seeded weights, final redrawn;
    returns (cfg, bf16 head, its fp32 copy)."""
    from dexbotic_tpu_torch.models.dit import DiT, DiTConfig, init_dit_
    from dexbotic_tpu_torch.nn.core import cast_like_jax_

    g = torch.Generator(device="cuda").manual_seed(seed)
    cfg = DiTConfig()
    with torch.device("cuda"):
        head = DiT(cfg)
    init_dit_(head, g)
    redraw_final_(head, g)
    head32 = copy.deepcopy(head)
    cast_like_jax_(head, torch.bfloat16)
    return cfg, head, head32, g


def phase_dit(failures: list, int8: bool = False) -> dict:
    """K2 against its plain version: bf16 weights (phase 4) or int8 block
    weights (4b: the bf16 head quantized as serving quantizes it; its fp32
    reference holds the same int8 values with fp32 scales), at B=1 (the
    served call), B=2 and B=8 (CogACT's 8-frame micro-batch: 16 rows with
    CFG), DDIM-10 and DPM-5, CFG 1.5; the plan's items and partial MB of
    every product are printed for each row count."""
    from dexbotic_tpu_torch.ops.diffusion import DiffusionSchedule
    from dexbotic_tpu_torch.ops.dit_fused import dit_sample_ref, fused_dit_sample, plan
    from dexbotic_tpu_torch.ops.quant import quantize_model_

    print("phase 4b: K2 dit_sample vs plain (DiT-B, int8 block weights)" if int8 else
          "phase 4: K2 dit_sample vs plain (DiT-B, bf16 weights)")
    dev = torch.device("cuda")
    cfg, head, head32, g = _dit_head(2)
    if int8:
        quantize_model_(head)
        head32 = copy.deepcopy(head)
        for p in head32.parameters():
            if p.is_floating_point():
                p.data = p.data.float()
    sched = DiffusionSchedule.create(100)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    worst, rows = 0.0, {}
    for B, sampler, steps in ((1, "ddim", 10), (2, "ddim", 10), (8, "ddim", 10), (1, "dpm", 5),
                              (2, "dpm", 5), (8, "dpm", 5)):
        z = torch.randn(B, 1, cfg.token_size, generator=g, device=dev)
        noise = torch.randn(B, cfg.chunk_size, cfg.in_channels, generator=g, device=dev)
        kw = dict(steps=steps, cfg_scale=1.5, sampler=sampler)
        out = fused_dit_sample(head, cfg, z, noise, sched, **kw)
        torch.cuda.synchronize()
        with plain_int8():
            ref = dit_sample_ref(head32, cfg, z, noise, sched, **kw)
            plain = dit_sample_ref(head, cfg, z, noise, sched, **kw)
            plain_ms = median_ms(lambda: dit_sample_ref(head, cfg, z, noise, sched, **kw), reps=3)
        err = (out - ref).abs().max().item()
        plain_err = (plain - ref).abs().max().item()
        ms = median_ms(lambda: fused_dit_sample(head, cfg, z, noise, sched, **kw))
        bound_ms, bound_by = dit_bound(head, cfg, B, steps, 1.5)
        check_bound(f"{sampler}-{steps} CFG 1.5 B={B}", err, plain_err, failures)
        alone, key = "", f"b{B}" if sampler == "ddim" else None
        if key:  # DDIM-10, the served sampler: the kernel's own device time and its plan
            dev_ms = device_ms(lambda: fused_dit_sample(head, cfg, z, noise, sched, **kw),
                               K2_KERNELS)
            alone = f" (alone {dev_ms:.4f} ms)"
            pl = plan(2 * B, cfg.chunk_size, cfg.hidden_size, cfg.mlp_dim, sms)
            desc = pl.describe(cfg.hidden_size, cfg.mlp_dim)
            print(f"    plan at {2 * B} rows: N tiles {pl.nt} x {pl.bn} rows; " + "; ".join(
                f"{name} {d['chunks']} chunks, {d['items']} items, {d['partial_mb']:.2f} MB of "
                f"partials" for name, d in desc.items() if isinstance(d, dict))
                + f" (a layer: {sum(pl.partial_bytes(cfg.hidden_size, cfg.mlp_dim).values()) / 1e6:.2f}"
                f" MB; its weights {dit_layer_bytes(head) / 1e6:.2f} MB)")
            rows[key] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "plan": desc}
        print(f"    |ref| max {ref.abs().max().item():.4g}  kernel {ms:.4f} ms{alone}  "
              f"plain bf16 {plain_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by})")
        worst = max(worst, err)
    main = {k: v for k, v in rows["b1"].items() if k != "plan"}
    return {"max_abs_err": worst, **main, "library_ms": None, "b1_plan": rows["b1"]["plan"],
            "b2": rows["b2"], "b8": rows["b8"]}


def dit_layer_bytes(head) -> int:
    """One DiT block's weight bytes (int8 q and scales, or the dense weights)."""
    return sum(p.numel() * p.element_size() for n, p in head.blocks[0].named_parameters()
               if not n.endswith("bias"))


# K4's cases: (layer, M, K, N).  Served: z_embed at every request (M = 2 rows
# with CFG at B=1; 16 at an 8-frame micro-batch) and t_mlp when K2's tables
# are built (M = 10 steps) or on the plain sampler path (16 rows at B=8).
# LLaMA-7B's widths at few rows.  Prefill: an int8 request's products of
# more rows, CLIP-L/336 (577 tokens, fp32 in the model), the mlp2x_gelu
# projector (576, fp32) and LLaMA-2-7B's prefill (the 832-token bucket and
# batch_size=2's 1664 rows, bf16).  Every case runs with bf16 and with fp32
# activations.
K4_SERVED = [("z_embed", 2, 4096, 768), ("z_embed", 16, 4096, 768),
             ("t_mlp.fc0", 10, 256, 768), ("t_mlp.fc0", 16, 256, 768),
             ("t_mlp.fc1", 10, 768, 768), ("t_mlp.fc1", 16, 768, 768)]
K4_LLAMA = [(f"llama {K}->{N}", M, K, N) for M in (1, 16, 64)
            for K, N in ((4096, 4096), (4096, 11008), (11008, 4096))]
K4_PREFILL = [("clip q/k/v/o", 577, 1024, 1024), ("clip fc1", 577, 1024, 4096),
              ("clip fc2", 577, 4096, 1024), ("projector fc0", 576, 1024, 4096),
              ("projector fc2", 576, 4096, 4096)] + [
    (f"llama prefill {K}->{N}", M, K, N) for M in (832, 1664)
    for K, N in ((4096, 4096), (4096, 11008), (11008, 4096))]
K4_CASES = K4_SERVED + K4_LLAMA + K4_PREFILL
# pi0 with int8 weights (phase 5f), fp32 activations only: every product an
# int8 request gives K4.  Gemma-2B's prefill at the served 832-token prefix
# (3 views x 256 + the 64-token text bucket), SigLIP so400m/224 over the 3
# views (768 rows; not fc2, whose K = 4304 is not a multiple of 64: K4 does
# not take it), the linear projector; then in each Euler step the
# Gemma-300M expert over the 51-token suffix (the state token and 50
# actions) and the time MLP over the 50 action tokens (the action
# projections, K or N = 32, are below inference_quantize_min_size).  Phase
# 5f fails if its requests give K4 a shape that is not here.
K4_PI0 = [("gemma prefill q/o 2048->2048", 832, 2048, 2048),
          ("gemma prefill k/v 2048->256", 832, 2048, 256),
          ("gemma prefill gate/up 2048->16384", 832, 2048, 16384),
          ("gemma prefill down 16384->2048", 832, 16384, 2048),
          ("siglip q/k/v/o 1152->1152", 768, 1152, 1152), ("siglip fc1 1152->4304", 768, 1152, 4304),
          ("pi0 projector 1152->2048", 768, 1152, 2048),
          ("expert q 1024->2048", 51, 1024, 2048), ("expert k/v 1024->256", 51, 1024, 256),
          ("expert o 2048->1024", 51, 2048, 1024), ("expert gate/up 1024->4096", 51, 1024, 4096),
          ("expert down 4096->1024", 51, 4096, 1024),
          ("time mlp in 2048->1024", 50, 2048, 1024), ("time mlp out 1024->1024", 50, 1024, 1024)]
# OFT-7B with int8 weights (phase 5h; the tower, projector and the Diffusion
# head's 832-row prefill are K4_PREFILL's): the L1 and Discrete joint
# forward over 832 + 112 rows, the DDIM segment's 113 rows, the noisy-action
# projector's fc2 over the 112 action tokens, Discrete's lm_head over them,
# in bf16; the MLPResNet (L1's head, Diffusion's noise predictor) over the
# chunk's 16 rows in fp32: fc1 from the 7 x 4096 concatenated hidden states,
# then its two 4096-wide blocks (its fc2, 4096 -> 7, is below
# inference_quantize_min_size).  Phase 5h fails if its requests give K4 a
# shape that is not here.
K4_OFT = [(f"oft {part} {K}->{N}", M, K, N)
          for part, M in (("joint", OFT_BUCKET + 112), ("ddim segment", 113))
          for K, N in ((4096, 4096), (4096, 11008), (11008, 4096))] + [
    ("oft noisy-action projector fc2", 112, 4096, 4096), ("oft lm_head", 112, 4096, 32000)]
K4_OFT_F32 = [("oft mlp_resnet fc1", 16, 7 * 4096, 4096), ("oft mlp_resnet block", 16, 4096, 4096)]
# MemVLA-7B with int8 weights (phase 11b; the tower, projector and the
# LLaMA prefill at 832 are K4_PREFILL's, z_embed at 2 rows K4_SERVED's):
# the SE bottleneck on the projector's fp32 tokens (its excitation at one
# pooled row), the per role's bank at 256 channels over the 576 per tokens
# (timestep embedder at the 16 bank slots and the frame, query and FFN,
# gate; its keys and values at 17 x 576 rows are past K4's rows) in fp32,
# the cog role's at 4096 channels over one token (its keys and values over
# the 16 slots and the token) in bf16, its timestep embedder in fp32; then
# in each DDIM step the DiT over 2 x 17 rows (CFG) in bf16 with its memory
# keys and values over 2 x 576 per tokens, the per-token embedder in fp32.
# Phase 11b fails if its requests give K4 a shape that is not here.
K4_MEMVLA_F32 = [("memvla se excite fc1", 1, 4096, 256), ("memvla se excite fc2", 1, 256, 4096),
                 ("memvla se reduce fc1", 576, 4096, 2048), ("memvla se reduce fc2", 576, 2048, 256),
                 ("memvla per time fc0/fc1", 16, 256, 256), ("memvla per time now", 1, 256, 256),
                 ("memvla per q", 576, 256, 256), ("memvla per ffn fc1", 576, 256, 1024),
                 ("memvla per ffn fc2", 576, 1024, 256), ("memvla per gate", 576, 512, 256),
                 ("memvla cog time fc0", 16, 256, 4096), ("memvla cog time fc1", 16, 4096, 4096),
                 ("memvla cog time now fc1", 1, 4096, 4096),
                 ("memvla per_token_embedder", 576, 256, 768)]
K4_MEMVLA_BF16 = [("memvla cog q", 1, 4096, 4096), ("memvla cog k/v", 17, 4096, 4096),
                  ("memvla cog ffn fc1", 1, 4096, 16384), ("memvla cog ffn fc2", 1, 16384, 4096),
                  ("memvla cog gate", 1, 8192, 4096), ("memvla dit t_mlp fc0", 2, 256, 768),
                  ("memvla dit t_mlp fc1", 2, 768, 768), ("memvla dit qkv", 34, 768, 2304),
                  ("memvla dit o / xattn q, o", 34, 768, 768),
                  ("memvla dit xattn k/v", 1152, 768, 768), ("memvla dit fc0", 34, 768, 3072),
                  ("memvla dit fc1", 34, 3072, 768)]
# Discrete VLA-7B and MUVLA-7B with int8 weights (phases 14e and 14f;
# LLaMA-2-7B's lm_head is untied, so the logits are K4's too): the decode
# engine's ticks at M = its slots (8 and 4) and generate's one-row steps,
# each with the lm_head, and generate's prefill of one prompt (855 and 959
# rows), in bf16; MUVLA's one-shot admission of one prompt (960 rows of its
# fp32 embeds), Discrete VLA's admission of two frames (the tower over 2 x
# 577 rows, the projector over 2 x 576), and MUVLA's fuse of a request in
# fp32: the QFormer's 192 queries, the fuser's 192 + 576 observation tokens
# against the map's 576, the projector over the 768 fused tokens (the
# history tower, the QFormer's keys and values and every admission past
# 1664 rows take the dequantize formulation or W8A8).  Phases 14e and 14f
# fail if their requests give K4 a shape that is not held here.
LLAMA_WIDTHS = ((4096, 4096), (4096, 11008), (11008, 4096))
K4_TEXT_BF16 = ([(f"llama decode {K}->{N}", M, K, N) for M in (4, 8) for K, N in LLAMA_WIDTHS]
                + [(f"llama lm_head {M} rows 4096->32000", M, 4096, 32000) for M in (1, 4, 8)]
                + [(f"llama generate prefill {K}->{N}", M, K, N) for M in (855, 959)
                   for K, N in LLAMA_WIDTHS])
K4_TEXT_F32 = ([(f"muvla admission {K}->{N}", 960, K, N) for K, N in LLAMA_WIDTHS]
               + [("clip 2 frames q/k/v/o", 1154, 1024, 1024), ("clip 2 frames fc1", 1154, 1024, 4096),
                  ("clip 2 frames fc2", 1154, 4096, 1024), ("projector 2 frames fc0", 1152, 1024, 4096),
                  ("projector 2 frames fc2", 1152, 4096, 4096), ("muvla qformer q/o", 192, 1024, 1024),
                  ("muvla fuser q/o", 768, 1024, 1024), ("muvla fuser k/v", 576, 1024, 1024),
                  ("muvla projector fc0", 768, 1024, 4096), ("muvla projector fc2", 768, 4096, 4096)])
K4_RUNS = ([(torch.bfloat16, c) for c in K4_CASES] + [(torch.float32, c) for c in K4_CASES]
           + [(torch.float32, c) for c in K4_PI0] + [(torch.bfloat16, c) for c in K4_OFT]
           + [(torch.float32, c) for c in K4_OFT_F32] + [(torch.float32, c) for c in K4_MEMVLA_F32]
           + [(torch.bfloat16, c) for c in K4_MEMVLA_BF16] + [(torch.bfloat16, c) for c in K4_TEXT_BF16]
           + [(torch.float32, c) for c in K4_TEXT_F32])
K4_CHECKED = {(M, K, N, dtype) for dtype, (_, M, K, N) in K4_RUNS}  # (rows, K, N, x dtype)


def phase_quant_matmul(failures: list) -> dict:
    """K4 against its plain version (the dequantize formulation, which
    quant_linear runs where K4 is not dispatched) at every case, each output
    against fp64; two calls must agree bit for bit; where the dispatch rule
    gives K4 the shape, K4 must not be slower than the plain version."""
    from dexbotic_tpu_torch.ops.quant import quantize_weight
    from dexbotic_tpu_torch.ops.quant_matmul import (plan, quant_matmul, quant_matmul_eligible,
                                                     quant_matmul_ref)

    print("phase 4c: K4 quant_matmul vs plain (int8 weights of bf16 layers; L2 flushed "
          "and the host's enqueue hidden before every timed call)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(10)
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def flush():  # a cold L2; the host enqueues the timed call behind ~0.2 ms of device work
        scratch.zero_()
        torch.cuda._sleep(400_000)

    worst, main, cases = 0.0, None, []
    for dtype, (name, M, K, N) in K4_RUNS:
        q, s = quantize_weight((torch.randn(N, K, generator=g, device=dev) * 0.02).bfloat16())
        s = s[:, 0].to(dtype)  # quant_linear casts the scales to x's dtype
        x = torch.randn(M, K, generator=g, device=dev).to(dtype)
        out = quant_matmul(x, q, s)
        again = quant_matmul(x, q, s)
        torch.cuda.synchronize()
        ref = quant_matmul_ref(x.double(), q, s.double())
        plain = quant_matmul_ref(x, q, s)
        err = (out.double() - ref).abs().max().item()
        label = f"{name} M={M} K={K} N={N} {str(dtype)[6:]}"
        check_bound(label, err, (plain.double() - ref).abs().max().item(), failures)
        if not torch.equal(out, again):
            failures.append(f"K4 {label}: two calls differ")
        del ref, plain, again
        w = q.to(dtype) * s[:, None]  # the dequantized weight
        # kernel, plain, kernel, plain: the medians of the pooled calls
        runs = [times_ms(fn, flush=flush) for fn in (lambda: quant_matmul(x, q, s),
                                                     lambda: quant_matmul_ref(x, q, s)) * 2]
        ms = statistics.median(runs[0] + runs[2])
        plain_ms = statistics.median(runs[1] + runs[3])
        dev_ms = device_ms(lambda: quant_matmul(x, q, s), K4_KERNELS)
        lib_ms = median_ms(lambda: torch.matmul(x, w.t()), flush=flush)
        lib_deq_ms = median_ms(lambda: torch.matmul(x, (q.to(dtype) * s[:, None]).t()),
                               flush=flush)
        bound_ms, bound_by = bound(nbytes(x, q, s, out), 2 * M * N * K, dtype)
        dispatched = quant_matmul_eligible(M, K, N)
        p = plan(M, K, N)
        print(f"    kernel {ms:.4f} ms, alone {dev_ms:.4f} ms ({p.rows} rows x "
              f"{p.channels} channels a block, {p.splits} split(s))  plain (dequantize "
              f"formulation) {plain_ms:.4f} ms  matmul on the dequantized weight "
              f"{lib_ms:.4f} ms, with the dequantize {lib_deq_ms:.4f} ms  bound "
              f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of it  "
              f"dispatched: {'yes' if dispatched else 'no'}")
        if dispatched and ms > plain_ms:
            failures.append(f"K4 {label}: dispatched, but {ms:.4f} ms > the dequantize "
                            f"formulation's {plain_ms:.4f} ms")
        worst = max(worst, err)
        cases.append({"case": label, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                      "library_ms": lib_ms, "library_with_dequantize_ms": lib_deq_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err,
                      "dispatched": dispatched})
        if main is None:  # z_embed at B=1, bf16: the served call
            main = {k: v for k, v in cases[0].items() if k not in ("case", "max_abs_err")}
        del q, s, x, out, w
    del scratch
    free_memory()
    return {"max_abs_err": worst, **main, "cases": cases}


@torch.no_grad()
def redraw_final_(head, gen) -> None:
    """The DiT's final layer is zero at init, which would make every sampled
    chunk depend on the noise alone; redraw it so the checks see the model."""
    head.final.weight.normal_(0.0, 0.02, generator=gen)
    head.final.bias.normal_(0.0, 0.02, generator=gen)


def _frame_png(seed: int = 0) -> bytes:
    from PIL import Image

    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)).save(buf, "PNG")
    return buf.getvalue()


def _post(port: int, prompt: str, frames: list, batch_size: int = 1, states: str | None = None,
          extra: dict | None = None):
    boundary = "dexboticsmoke"
    fields = {"text": prompt, "batch_size": batch_size, **(extra or {})}
    if states is not None:
        fields["states"] = states
    body = "".join(f"--{boundary}\r\nContent-Disposition: form-data; name=\"{k}\"\r\n\r\n{v}\r\n"
                   for k, v in fields.items()).encode()
    for i, png in enumerate(frames):
        body += (f"--{boundary}\r\nContent-Disposition: form-data; name=\"image\"; "
                 f"filename=\"f{i}.png\"\r\nContent-Type: image/png\r\n\r\n").encode()
        body += png + b"\r\n"
    body += f"--{boundary}--\r\n".encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/process_frame", data=body,
        headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        out = np.asarray(json.loads(r.read()))
    return out, time.perf_counter() - t0


PROMPT = "pick up the moka pot"


def timed_dumps(server) -> list:
    """Time each of ``server``'s request dumps on the host (seconds, appended
    to the list returned), through an instance attribute that the HTTP
    handler and the micro-batch worker both call."""
    seconds = []
    dump = server._maybe_dump

    def timed(fields, files, result):
        t0 = time.perf_counter()
        try:
            dump(fields, files, result)
        finally:
            seconds.append(time.perf_counter() - t0)

    server._maybe_dump = timed
    return seconds


def check_dumps(label: str, dump_dir: str, answered: list, seconds: list, failures: list) -> dict:
    """Hold a server's request dumps (``save_image_dir``) to the requests it
    answered, [(posted frames, response)]: one resp_*.json and one
    frame_*_0.png a request, a frame file a posted frame with its bytes as
    posted, each dump's result the response's body (matched as a multiset:
    concurrent requests are numbered in the order the server answered them);
    prints the dumps' host time beside the card's name and power limit."""
    names = sorted(os.listdir(dump_dir))
    resps = [n for n in names if n.startswith("resp_")]
    dumped = []
    for name in resps:
        i = name[len("resp_"):-len(".json")]
        with open(os.path.join(dump_dir, name)) as f:
            result = json.load(f)["result"]
        frames, j = [], 0
        while os.path.exists(os.path.join(dump_dir, f"frame_{i}_{j}.png")):
            with open(os.path.join(dump_dir, f"frame_{i}_{j}.png"), "rb") as f:
                frames.append(f.read())
            j += 1
        dumped.append((tuple(frames), json.dumps(np.asarray(result).tolist())))
    posted = [(tuple(frames), json.dumps(np.asarray(out).tolist())) for frames, out in answered]
    firsts = sum(n.startswith("frame_") and n.endswith("_0.png") for n in names)
    n_frames = sum(n.startswith("frame_") for n in names)
    nbytes = sum(os.path.getsize(os.path.join(dump_dir, n)) for n in names)
    ok = (len(resps) == firsts == len(answered) and n_frames == sum(len(f) for f, _ in answered)
          and sorted(dumped) == sorted(posted))
    print(f"  {label} request dumps: {len(resps)} resp_*.json and {n_frames} frame files "
          f"({nbytes / 1e6:.2f} MB) for {len(answered)} answered requests, bytes and results as "
          f"posted: {ok}; host time {sum(seconds) * 1e3:.3f} ms in {len(seconds)} dumps "
          f"({statistics.median(seconds) * 1e3 if seconds else 0.0:.3f} ms median, "
          f"{max(seconds, default=0.0) * 1e3:.3f} max) on {card_line()}")
    if not ok:
        failures.append(f"{label}: {len(resps)} dumps ({firsts} first frames, {n_frames} frame "
                        f"files) for {len(answered)} answered requests, frames and results as "
                        f"posted: {sorted(dumped) == sorted(posted)}")
    return {"requests": len(answered), "resp_files": len(resps), "frame_files": n_frames,
            "bytes": nbytes, "host_ms": sum(seconds) * 1e3, "as_posted": ok}


# ---------------------------------------------------------------------------
# Reference checkpoints: the port's model under the reference's key names
# (phases 5e and 5f; tests/test_torch_convert.py).  This inverts
# dexbotic_tpu_torch/utils/convert.py.
# ---------------------------------------------------------------------------

CKPT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_checkpoints")

# (port name pattern, reference name) within a decoder, a tower and the DiT
LLM_RULES = [(r"^layers\.(\d+)\.ln1\.", r"layers.\1.input_layernorm."),
             (r"^layers\.(\d+)\.ln2\.", r"layers.\1.post_attention_layernorm."),
             (r"^layers\.(\d+)\.attn\.(q|k|v|o)\.", r"layers.\1.self_attn.\2_proj."),
             (r"^layers\.(\d+)\.attn\.(q_norm|k_norm)\.", r"layers.\1.self_attn.\2."),
             (r"^layers\.(\d+)\.mlp\.(gate|up|down)\.", r"layers.\1.mlp.\2_proj."),
             (r"^norm\.", "norm."), (r"^embed\.weight$", "embed_tokens.weight")]
VIT_RULES = [(r"^patch_embed\.", "embeddings.patch_embedding."),
             (r"^pos_embed$", "embeddings.position_embedding.weight"),
             (r"^cls$", "embeddings.class_embedding"), (r"^pre_ln\.", "pre_layrnorm."),
             (r"^post_ln\.", "post_layernorm."),
             (r"^layers\.(\d+)\.ln(1|2)\.", r"encoder.layers.\1.layer_norm\2."),
             (r"^layers\.(\d+)\.attn\.(q|k|v)\.", r"encoder.layers.\1.self_attn.\2_proj."),
             (r"^layers\.(\d+)\.attn\.o\.", r"encoder.layers.\1.self_attn.out_proj."),
             (r"^layers\.(\d+)\.mlp\.", r"encoder.layers.\1.mlp.")]
DIT_RULES = [(r"^x_embed\.", "x_embedder.linear."), (r"^t_mlp\.fc0\.", "t_embedder.mlp.0."),
             (r"^t_mlp\.fc1\.", "t_embedder.mlp.2."), (r"^z_embed\.", "z_embedder.linear."),
             (r"^pos_embed$", "positional_embedding"), (r"^final\.", "final_layer.linear."),
             (r"^uncondition$", "z_embedder.uncondition"),
             (r"^blocks\.(\d+)\.attn\.qkv\.", r"blocks.\1.attn.qkv."),
             (r"^blocks\.(\d+)\.attn\.o\.", r"blocks.\1.attn.proj."),
             (r"^blocks\.(\d+)\.mlp\.fc0\.", r"blocks.\1.mlp.fc1."),
             (r"^blocks\.(\d+)\.mlp\.fc1\.", r"blocks.\1.mlp.fc2.")]


# OFT's heads: the MLPResNet (L1's ``model.``, Diffusion's ``noise_predictor.mlp_resnet.``)
MLP_RESNET_RULES = [(r"^ln(1|2)\.", r"layer_norm\1."), (r"^fc(1|2)\.", r"fc\1."),
                    (r"^blocks\.(\d+)\.ln\.", r"mlp_resnet_blocks.\1.ffn.0."),
                    (r"^blocks\.(\d+)\.fc\.", r"mlp_resnet_blocks.\1.ffn.1.")]


# MemVLA's own modules (models/memvla.py) under the reference's names
MEM_RULES = [(r"^per_compr\.excite\.fc1\.", "per_compr.excite.1."),
             (r"^per_compr\.excite\.fc2\.", "per_compr.excite.3."),
             (r"^per_compr\.reduce\.fc1\.", "per_compr.reduce.0."),
             (r"^per_compr\.reduce\.fc2\.", "per_compr.reduce.2."),
             (r"^mem_bank\.(per|cog)\.retrieval\.(\d+)\.(q|k|v)\.",
              r"per_cog_mem_bank.retrieval_blocks.\1.\2.\3_proj."),
             (r"^mem_bank\.(per|cog)\.retrieval\.(\d+)\.(attn|ffn)_ln\.",
              r"per_cog_mem_bank.retrieval_blocks.\1.\2.\3_norm."),
             (r"^mem_bank\.(per|cog)\.retrieval\.(\d+)\.ffn\.fc1\.",
              r"per_cog_mem_bank.retrieval_blocks.\1.\2.ffn.0."),
             (r"^mem_bank\.(per|cog)\.retrieval\.(\d+)\.ffn\.fc2\.",
              r"per_cog_mem_bank.retrieval_blocks.\1.\2.ffn.3."),
             (r"^mem_bank\.(per|cog)\.gate\.proj\.", r"per_cog_mem_bank.gate_fusion_blocks.\1.proj."),
             (r"^mem_bank\.(per|cog)\.time\.fc0\.", r"per_cog_mem_bank.timestep_embedders.\1.mlp.0."),
             (r"^mem_bank\.(per|cog)\.time\.fc1\.", r"per_cog_mem_bank.timestep_embedders.\1.mlp.2.")]
MEM_DIT_RULES = [(r"^per_token_embedder\.", "per_token_embedder.linear."),
                 (r"^blocks\.(\d+)\.xattn\.o\.", r"blocks.\1.per_attn.out_proj."),
                 (r"^blocks\.(\d+)\.xattn\.ln\.", r"blocks.\1.norm3.")]


def _oft_head_name(name: str) -> str:
    """The reference name of an OFT head parameter, under ``model.action_head.``."""
    import re

    m = re.match(r"^(mlp|noise_predictor)\.(.*)$", name)
    if m:
        inner = _renamed(m.group(2), MLP_RESNET_RULES)
        return ("model." if m.group(1) == "mlp" else "noise_predictor.mlp_resnet.") + inner
    if re.match(r"^(noisy_action_projector|proprio_projector)\.fc(1|2)\.(weight|bias)$", name):
        return name
    raise KeyError(f"no reference name for the OFT head parameter {name}")


def _renamed(name: str, rules: list) -> str:
    import re

    for pat, rep in rules:
        if re.match(pat, name):
            return re.sub(pat, rep, name)
    raise KeyError(f"no reference name for the port parameter {name}")


def reference_state_dict(model, cfg) -> dict:
    """{reference name: tensor} of a CogACT, MemVLA, flow-VLA (pi0, pi0.5,
    DM0) or OFT model: the layout utils/convert.py reads (Dexbotic's
    ``model.llm.``, ``model.mm_vision_tower.vision_tower.vision_model.``,
    ``model.mm_projector.``, ``model.action_head.net.`` (the DiT),
    ``model.action_head.`` (OFT's heads), ``model.per_compr.`` and
    ``model.per_cog_mem_bank.`` (MemVLA's), ``model.action_expert[.model].``;
    torch Linear layouts; conv patch embeds, MemVLA's 1x1 convs and the
    DiT's packed ``per_attn.in_proj``).  The tensors keep the model's dtypes
    and device (a packed in_proj is a new tensor); CLIP's patch embed has no
    bias (it must be zero)."""
    import re

    from dexbotic_tpu_torch.utils.convert import VIT_PREFIX

    vit = cfg.vlm.vit
    out, packed = {}, {}
    for name, p in model.named_parameters():
        t = p.detach()
        m = re.match(r"^action_head\.blocks\.(\d+)\.xattn\.(q|k|v)\.(weight|bias)$", name)
        if m:  # MemVLA's per_attn: q, k and v packed into one in_proj, after the loop
            packed.setdefault((m.group(1), m.group(3)), {})[m.group(2)] = t
            continue
        if name.startswith(("per_compr.", "mem_bank.")):
            ref = _renamed(name, MEM_RULES)
            out["model." + ref] = t[:, :, None, None] if ref.startswith("per_compr.") and \
                ref.endswith("weight") else t
        elif name.startswith("action_head.") and re.match(
                r"^(per_token_embedder|blocks\.\d+\.xattn)\.", name[12:]):
            out["model.action_head.net." + _renamed(name[12:], MEM_DIT_RULES)] = t
        elif name == "vlm.llm.lm_head.weight":
            out["lm_head.weight"] = t
        elif name.startswith("vlm.llm."):
            out["model.llm." + _renamed(name[8:], LLM_RULES)] = t
        elif name.startswith("vlm.vit."):
            sub = name[8:]
            if sub == "patch_embed.weight":  # [H, p*p*3] (row, col, channel) -> [H, 3, p, p]
                pp = vit.patch_size
                t = t.reshape(t.shape[0], pp, pp, 3).permute(0, 3, 1, 2)
            elif sub == "patch_embed.bias" and vit.use_cls:
                if t.count_nonzero():
                    raise ValueError("CLIP's patch embed has no bias, and this one is not zero")
                continue
            out[VIT_PREFIX + _renamed(sub, VIT_RULES)] = t
        elif name.startswith("vlm.projector."):
            m = re.match(r"^fc(\d*)\.(weight|bias)$", name[14:])
            ref = m.group(2) if m.group(1) == "" else f"{2 * int(m.group(1))}.{m.group(2)}"
            out["model.mm_projector." + ref] = t
        elif name == "action_head.action_query":  # OFT-L1: [1, tokens, H] in the reference
            out["model.action_head.action_query"] = t[None]
        elif name.startswith("action_head.") and not hasattr(cfg, "dit"):
            out["model.action_head." + _oft_head_name(name[12:])] = t
        elif name.startswith("action_head."):
            ref = _renamed(name[12:], DIT_RULES)
            out["model.action_head.net." + ref] = t[None] if ref.endswith("uncondition") else t
        elif name.startswith("expert."):
            prefix = "model.action_expert.model." if cfg.causal_prefix else "model.action_expert."
            out[prefix + _renamed(name[7:], LLM_RULES)] = t
        else:
            head, leaf = name.rsplit(".", 1)
            ref = {"action_in_proj": "action_in_proj", "action_out_proj": "action_out_proj",
                   "state_proj": "state_proj",
                   "time_mlp_in": "action_time_mlp_in" if cfg.time_in_suffix else "time_mlp_in",
                   "time_mlp_out": "action_time_mlp_out" if cfg.time_in_suffix else "time_mlp_out"}
            if head not in ref:
                raise KeyError(f"no reference name for the port parameter {name}")
            out[f"model.{ref[head]}.{leaf}"] = t
    for (block, leaf), qkv in packed.items():
        out[f"model.action_head.net.blocks.{block}.per_attn.in_proj_{leaf}"] = torch.cat(
            [qkv["q"], qkv["k"], qkv["v"]])
    return out


def write_safetensors(path: str, tensors: dict) -> int:
    """Write {name: tensor} in the safetensors layout (an 8-byte little-endian
    header length, a JSON header padded to 8 bytes, the raw little-endian
    bytes in header order); returns the file's bytes."""
    import struct

    from dexbotic_tpu_torch.utils.convert import SAFETENSORS_DTYPES

    names = {v: k for k, v in SAFETENSORS_DTYPES.items()}
    header, off = {}, 0
    for k in sorted(tensors):
        t = tensors[k]
        n = t.numel() * t.element_size()
        header[k] = {"dtype": names[t.dtype], "shape": list(t.shape), "data_offsets": [off, off + n]}
        off += n
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for k in sorted(tensors):
            t = tensors[k].contiguous().cpu().reshape(-1)
            f.write(t.view(torch.uint8).numpy().data)
    return 8 + len(head) + off


def write_checkpoint(sd: dict, out_dir: str, fmt: str = "safetensors", dtype=None,
                     shard_bytes: int = 4 << 30, config: dict | None = None) -> int:
    """Write a reference state dict as HF shards (``model-0000i-of-0000n.safetensors``
    or ``pytorch_model-0000i-of-0000n.bin`` with their index, and
    ``config.json``); ``dtype`` casts the floating tensors.  Returns the
    weight files' bytes."""
    os.makedirs(out_dir, exist_ok=True)
    if dtype is not None:
        sd = {k: v.to(dtype) if v.is_floating_point() else v for k, v in sd.items()}
    shards, cur, size = [], {}, 0
    for k in sorted(sd):
        n = sd[k].numel() * sd[k].element_size()
        if cur and size + n > shard_bytes:
            shards.append(cur)
            cur, size = {}, 0
        cur[k] = sd[k]
        size += n
    shards.append(cur)
    stem, ext = ("model", "safetensors") if fmt == "safetensors" else ("pytorch_model", "bin")
    total, weight_map = 0, {}
    for i, shard in enumerate(shards):
        fname = f"{stem}-{i + 1:05d}-of-{len(shards):05d}.{ext}"
        path = os.path.join(out_dir, fname)
        if fmt == "safetensors":
            total += write_safetensors(path, shard)
        else:
            torch.save({k: v.contiguous().cpu() for k, v in shard.items()}, path)
            total += os.path.getsize(path)
        weight_map.update({k: fname for k in shard})
    with open(os.path.join(out_dir, f"{stem}.{ext}.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(config or {}, f)
    return total


def host_rss_gib() -> float:
    """The process's resident set in GiB, from /proc/self/status."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 2**20
    return float("nan")


@contextlib.contextmanager
def sampled_host_peak(interval_s: float = 0.005):
    """{"peak_gib": the largest resident set seen while inside}, sampled every
    ``interval_s`` by a thread (a process may not be allowed to reset the
    kernel's high-water mark, /proc/self/clear_refs)."""
    import threading

    out, stop = {"peak_gib": host_rss_gib()}, threading.Event()

    def sample():
        while not stop.is_set():
            out["peak_gib"] = max(out["peak_gib"], host_rss_gib())
            stop.wait(interval_s)

    t = threading.Thread(target=sample, daemon=True)
    t.start()
    try:
        yield out
    finally:
        stop.set()
        t.join()
        out["peak_gib"] = max(out["peak_gib"], host_rss_gib())


QUANT_ROUTES = ("k4", "dequant", "w8a8")


def quant_route(rows: int, K: int, N: int, device: str) -> str:
    """Where ops/quant_matmul.quant_linear sends a product of ``rows`` rows
    of a tensor on ``device``: "w8a8" from W8A8_MIN_ROWS rows when that is
    set, else "k4" on the card where KERNEL_DISPATCH is on and K4 takes the
    shape, else "dequant" (the dequantize formulation)."""
    from dexbotic_tpu_torch.ops import quant_matmul as qm

    if qm.W8A8_MIN_ROWS is not None and rows >= qm.W8A8_MIN_ROWS:
        return "w8a8"
    if qm.KERNEL_DISPATCH and device == "cuda" and qm.quant_matmul_eligible(rows, K, N):
        return "k4"
    return "dequant"


def quant_route_counts(passes: list) -> dict:
    """{route: products} the dispatch rule gives ``passes``: (module, rows)
    pairs, every QuantLinear inside the module run once at that many rows,
    on the device its weights are on."""
    from dexbotic_tpu_torch.nn.core import QuantLinear

    counts = dict.fromkeys(QUANT_ROUTES, 0)
    for mod, rows in passes:
        for m in mod.modules():
            if isinstance(m, QuantLinear):
                counts[quant_route(rows, m.in_features, m.out_features, m.q.device.type)] += 1
    return counts


def k4_products(model, cfg, llm_rows: int, batch: int = 1) -> dict:
    """{part: the quantized products of one request of ``batch`` frames that
    the dispatch rule gives K4}, counted from the model: every QuantLinear
    of the layers the request runs (the LLM's at the prompt's bucket, the
    ViT's up to select_layer, the projector's, the DiT's z_embed at 2 rows a
    frame with CFG) whose (rows, K, N) quant_linear sends to K4.  The DiT's
    other layers run inside K2 or once per process (t_mlp's tables)."""
    vit = cfg.vlm.vit
    vit_layers = vit.num_layers + (vit.select_layer + 1 if vit.select_layer is not None else 0)
    rows_z = batch * (2 if cfg.cfg_scale > 1.0 else 1)
    parts = {"llm": (model.vlm.llm.layers, batch * llm_rows),
             "vit": (model.vlm.vit.layers[:vit_layers], batch * vit.seq_len),
             "projector": (model.vlm.projector, batch * vit.num_output_tokens),
             "z_embed": (model.action_head.z_embed, rows_z)}
    return {part: quant_route_counts([(mod, rows)])["k4"] for part, (mod, rows) in parts.items()}


class RoutesSeen(collections.Counter):
    """quant_routes_seen's count: (module prefix, route) -> products."""

    def routes(self) -> dict:
        """{route: products} over every module."""
        out = dict.fromkeys(QUANT_ROUTES, 0)
        for (_, route), n in self.items():
            out[route] += n
        return out

    def k4(self) -> dict:
        """{module prefix: products sent to K4}."""
        return {prefix: n for (prefix, route), n in self.items() if route == "k4"}


@contextlib.contextmanager
def quant_routes_seen(model, shapes: set | None = None):
    """The routes the dispatch rule (quant_route) gives the QuantLinear calls
    of ``model`` while inside, on any thread: a RoutesSeen keyed by the
    module's first two name parts, from forward pre-hooks on the rows and
    the device each call sees; each K4 product's (rows, K, N, x dtype) is
    added to ``shapes``."""
    import threading

    from dexbotic_tpu_torch.nn.core import QuantLinear

    seen, lock, handles = RoutesSeen(), threading.Lock(), []
    for name, m in model.named_modules():
        if isinstance(m, QuantLinear):
            def hook(mod, args, prefix=".".join(name.split(".")[:2])):
                x = args[0]
                rows = x.numel() // mod.in_features
                route = quant_route(rows, mod.in_features, mod.out_features, x.device.type)
                with lock:
                    seen[prefix, route] += 1
                    if route == "k4" and shapes is not None:
                        shapes.add((rows, mod.in_features, mod.out_features, x.dtype))
            handles.append(m.register_forward_pre_hook(hook))
    try:
        yield seen
    finally:
        for h in handles:
            h.remove()


@torch.no_grad()
def cogact_parts_ms(model, cfg, ids, valid, imgs, noise) -> dict:
    """A CogACT request's device path by part, each timed alone as a
    CUDA-synchronised median of 5 (``wall_ms``): the ViT and projector
    (``encode_images``), the LLM prefill on the spliced embeddings, the
    action sampler on the cognition feature (K2 where
    ``cogact_inference_action`` takes it by K2's shape rule, else the plain
    loop), and the whole call; at the batch of ``ids`` (1 or 8 frames)."""
    from dexbotic_tpu_torch.models.cogact import (cogact_inference_action, cognition_feature,
                                                  k2_uses, schedule)
    from dexbotic_tpu_torch.models.vlm import encode_images, splice_image_embeds, vlm_forward
    from dexbotic_tpu_torch.ops.dit_fused import dit_sample_ref, fused_dit_sample
    from script.profile_pi0_torch import wall_ms

    embeds = splice_image_embeds(model.vlm, cfg.vlm, ids, encode_images(model.vlm, cfg.vlm, imgs))
    z = cognition_feature(model, cfg, ids, valid, imgs)[0][:, None, :].float()
    fused = cfg.fused_sampler and k2_uses(cfg, z.shape[0], cfg.cfg_scale)
    sample = fused_dit_sample if fused else dit_sample_ref
    kw = dict(steps=cfg.ddim_steps, cfg_scale=cfg.cfg_scale, sampler=cfg.sampler)
    return {
        "tower_projector_ms": wall_ms(lambda: encode_images(model.vlm, cfg.vlm, imgs), reps=5),
        "prefill_ms": wall_ms(lambda: vlm_forward(model.vlm, cfg.vlm, ids, valid,
                                                  inputs_embeds=embeds), reps=5),
        "sampler_ms": wall_ms(lambda: sample(model.action_head, cfg.dit, z, noise, schedule(cfg),
                                             **kw), reps=5),
        "device_call_ms": wall_ms(lambda: cogact_inference_action(model, cfg, ids, valid, imgs,
                                                                  noise=noise), reps=5)}


def phase_slice(failures: list, quantize: str = "", bf16: dict | None = None) -> dict:
    """Serve CogACT-7B over HTTP with the launch counts read around the
    requests, then hold the kernel path against the plain path on one frame
    and on an 8-frame batch.

    Phase 5 (bf16): six single frames, a batch_size=2 request and an 8-frame
    one, which K2 must serve in one launch (16 rows with CFG).  Phase 5b
    (``quantize``): the same seeded model quantized, the same requests; ``bf16``
    is phase 5's result, for the int8 chunk's cosine to the bf16 chunk and
    the latency and parts beside it."""
    from dexbotic_tpu_torch.data import fast_image
    from dexbotic_tpu_torch.exp import base_exp
    from dexbotic_tpu_torch.exp.cogact_exp import CogActExp, CogActModelConfig
    from dexbotic_tpu_torch.exp.serve import CogActServer, _cogact_images, _cogact_prompt_ids
    from dexbotic_tpu_torch.models.cogact import cogact_inference_action
    from dexbotic_tpu_torch.ops import quant_matmul as qm
    from dexbotic_tpu_torch.ops.attention import attention, flash_attention
    from dexbotic_tpu_torch.ops.dit_fused import fused_dit_sample
    from dexbotic_tpu_torch.ops.quant import quantized_bytes

    print(f"phase 5b: CogACT-7B, inference_quantize={quantize!r}, served through /process_frame"
          if quantize else "phase 5: CogACT-7B served through /process_frame")
    exp = CogActExp(model=CogActModelConfig(), data=base_exp.DataConfig(image_processor="clip_336"),
                    device="cuda", inference_quantize=quantize)
    t0 = time.perf_counter()
    cfg, model, norms = exp.load_for_inference()
    redraw_final_(model.action_head, torch.Generator(device="cuda").manual_seed(3))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = quantized_bytes(model)
    print(f"  built {n_params / 1e9:.3f}B params on the card in {time.perf_counter() - t0:.1f} s, "
          f"{weight_bytes / 2**30:.2f} GiB of weights, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated; host image path: "
          f"{'fast_image (g++)' if fast_image.available() else 'numpy'}")
    tokenizer = exp.tokenizer.build_tokenizer()
    server = CogActServer(exp, cfg, model, tokenizer, norms, host="127.0.0.1", port=0)
    httpd = server.serve_background()
    port = httpd.server_address[1]
    png, prompt = _frame_png(), PROMPT
    kernels = {"flash_fwd": flash_attention, "dit_sample": fused_dit_sample}
    if quantize:
        kernels["quant_matmul"] = qm.quant_matmul
    try:
        for fn in kernels.values():
            fn.launches = 0
        attention.plain_cuda_calls = 0
        singles, latencies = [], []
        for _ in range(6):
            out, dt = _post(port, prompt, [png])
            singles.append(out)
            latencies.append(dt)
        if quantize:  # 5b dumps the requests after its timed singles (the reference's debug dumps)
            server.save_image_dir = dump_dir = tempfile.mkdtemp(prefix="dumps_5b_")
            dump_s = timed_dumps(server)
        batch, batch_dt = _post(port, f"{prompt};{prompt}", [png, png], batch_size=2)
        # 8 x 832 = 6656 rows (int8: W8A8 in the prefill); 16 sampler rows: K2, once
        k2_before = fused_dit_sample.launches
        batch8, batch8_dt = _post(port, ";".join([prompt] * 8), [png] * 8, batch_size=8)
        k2_batch8 = fused_dit_sample.launches - k2_before
        launches = {name: fn.launches for name, fn in kernels.items()}
        plain_calls = attention.plain_cuda_calls
        if quantize:  # one more single frame: K4's launches against the rule's products
            with quant_routes_seen(model) as seen:
                qm.quant_matmul.launches = 0
                k4_out, _ = _post(port, prompt, [png])
                k4_single = qm.quant_matmul.launches
    finally:
        httpd.shutdown()
        httpd.server_close()
    if quantize:
        answered = [([png, png], batch), ([png] * 8, batch8), ([png], k4_out)]
        dumps = check_dumps("5b", dump_dir, answered, dump_s, failures)
        shutil.rmtree(dump_dir)
    print(f"  launches during serving: {launches}; plain attention calls on CUDA {plain_calls}")
    if plain_calls:
        failures.append(f"{plain_calls} attention calls of the served LLM took the plain path")
    for out in singles:
        if out.shape != (cfg.chunk_size, cfg.action_dim) or not np.isfinite(out).all():
            failures.append(f"single response shape {out.shape} / finite {np.isfinite(out).all()}")
    if batch.shape != (2, cfg.chunk_size, cfg.action_dim) or not np.isfinite(batch).all():
        failures.append(f"batch response shape {batch.shape}")
    if batch8.shape != (8, cfg.chunk_size, cfg.action_dim) or not np.isfinite(batch8).all():
        failures.append(f"8-frame response shape {batch8.shape}")
    print(f"  K2 launches in the 8-frame request: {k2_batch8}")
    if k2_batch8 != 1:
        failures.append(f"the 8-frame request launched K2 {k2_batch8} times, not once")
    for name, n in launches.items():
        if n <= 0:
            failures.append(f"kernel {name} was not launched on the served path")
    n_tok = len(_cogact_prompt_ids(exp, cfg, tokenizer, prompt))
    p50 = statistics.median(latencies[1:]) * 1e3
    print(f"  prompt {n_tok} tokens; request latency ms: first {latencies[0] * 1e3:.1f}, "
          f"p50 of the rest {p50:.1f}, batch_size=2 {batch_dt * 1e3:.1f}, "
          f"8 frames {batch8_dt * 1e3:.1f}")

    # the same frame through the kernel path and the plain path, same noise
    L = -(-n_tok // 64) * 64
    ids = torch.zeros((1, L), dtype=torch.int32, device="cuda")
    valid = torch.zeros_like(ids)
    ids[0, :n_tok] = torch.tensor(_cogact_prompt_ids(exp, cfg, tokenizer, prompt), device="cuda")
    valid[0, :n_tok] = 1
    imgs = torch.from_numpy(_cogact_images([png], exp.data.build_image_processor()))[None].cuda()
    noise = torch.randn((1, cfg.chunk_size, cfg.action_dim),
                        generator=torch.Generator(device="cuda").manual_seed(4), device="cuda")
    cfg_plain = dataclasses.replace(plain_config(cfg), fused_sampler=False)
    a = cogact_inference_action(model, cfg, ids, valid, imgs, noise=noise).flatten()
    with plain_int8():
        b = cogact_inference_action(model, cfg_plain, ids, valid, imgs, noise=noise).flatten()
    cos = _cosine(a, b)
    diff = (a - b).abs().max().item()
    print(f"  kernel path vs plain path: max abs diff {diff:.5g}, cosine {cos:.6f}, "
          f"|chunk| max {b.abs().max().item():.4g}")
    if not cos >= 0.99:
        failures.append(f"slice cosine {cos} < 0.99")
    # the 8-frame micro-batch (the same frame 8 times, fresh noise): K2 at 16 rows
    ids8, valid8, imgs8 = (t.expand(8, *t.shape[1:]).contiguous() for t in (ids, valid, imgs))
    noise8 = torch.randn((8, cfg.chunk_size, cfg.action_dim),
                         generator=torch.Generator(device="cuda").manual_seed(5), device="cuda")
    n0 = fused_dit_sample.launches
    a8 = cogact_inference_action(model, cfg, ids8, valid8, imgs8, noise=noise8).flatten()
    k2_b8 = fused_dit_sample.launches - n0
    with plain_int8():
        b8 = cogact_inference_action(model, cfg_plain, ids8, valid8, imgs8, noise=noise8).flatten()
    cos8 = _cosine(a8, b8)
    print(f"  8 frames, kernel path (K2 launches: {k2_b8}) vs plain path: max abs diff "
          f"{(a8 - b8).abs().max().item():.5g}, cosine {cos8:.6f}")
    if k2_b8 != 1 or not cos8 >= 0.99:
        failures.append(f"8-frame kernel path: {k2_b8} K2 launches, cosine {cos8} (want 1, >= 0.99)")
    del b8
    parts = cogact_parts_ms(model, cfg, ids, valid, imgs, noise)
    parts8 = cogact_parts_ms(model, cfg, ids8, valid8, imgs8, noise8)
    result = {"launches": launches, "chunk": a, "p50_ms": p50, "weight_bytes": weight_bytes,
              "parts": parts, "parts_b8": parts8, "cos_b8": cos8, "k2_b8_request": k2_batch8}
    if not quantize:  # the model and one frame's inputs, for phases 5d and 5e
        result.update(model=model, exp=exp, cfg=cfg, tokenizer=tokenizer, norms=norms,
                      inputs=(ids, valid, imgs, noise))
    if quantize:
        want = k4_products(model, cfg, L)
        print(f"  K4 launches in one single-frame request: {k4_single}; the rule's products, "
              f"from the model: {sum(want.values())} {want}; from forward hooks: "
              f"{seen.routes()['k4']} {seen.k4()}")
        if not k4_single == sum(want.values()) == seen.routes()["k4"]:
            failures.append(f"K4 launched {k4_single} times in a single-frame request; the "
                            f"dispatch rule gives it {sum(want.values())} products {want}, "
                            f"the hooks saw {seen.routes()['k4']}")
        result["k4_single_request"] = k4_single
        result["dumps"] = dumps
        qm.W8A8_MIN_ROWS = None  # "w8a8" set it for this process
        cos_bf16 = _cosine(a, bf16["chunk"])
        print(f"  int8 vs bf16 (phase 5, same seed, frame and noise): weights "
              f"{weight_bytes / 2**30:.2f} vs {bf16['weight_bytes'] / 2**30:.2f} GiB; request p50 "
              f"{p50:.1f} vs {bf16['p50_ms']:.1f} ms; chunk cosine {cos_bf16:.6f}")
        for label, mine, theirs in (("", parts, bf16["parts"]), (", 8 frames", parts8,
                                                                 bf16["parts_b8"])):
            print(f"  device path by part{label}, int8 vs bf16 (ms, CUDA-synchronised): "
                  + "; ".join(f"{k[:-3]} {v:.2f} vs {theirs[k]:.2f}" for k, v in mine.items()))
        if not cos_bf16 >= 0.99:
            failures.append(f"int8 vs bf16 chunk cosine {cos_bf16} < 0.99")
    else:
        for label, pts in (("", parts), (", 8 frames", parts8)):
            print(f"  device path by part{label} (ms, CUDA-synchronised): "
                  + "; ".join(f"{k[:-3]} {v:.2f}" for k, v in pts.items()))
    return result


def phase_pi0(failures: list) -> dict:
    """Serve pi0 at full width over HTTP with K1's launches and the plain
    CUDA attention calls counted around the requests; hold the kernel path
    against the plain path on one request; time the device path by part."""
    from dexbotic_tpu_torch.data.image_processing import preprocess_images_batch
    from dexbotic_tpu_torch.exp.pi0_exp import Pi0Exp
    from dexbotic_tpu_torch.exp.serve import FlowVLAServer, _decode_frames
    from dexbotic_tpu_torch.models import flow_vla as fv
    from dexbotic_tpu_torch.ops.attention import attention, flash_attention, flash_attention_fwd
    from script.profile_pi0_torch import part_calls, split_parts, wall_ms

    print("phase 5c: pi0 (SigLIP so400m/224 + Gemma-2B + Gemma-300M expert, bf16 weights, "
          "fp32 activations) served through /process_frame")
    exp = Pi0Exp(device="cuda")
    t0 = time.perf_counter()
    cfg, model, _ = exp.load_for_inference()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  built {n_params / 1e9:.3f}B params on the card in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    rng = np.random.default_rng(12)
    # pi0-format statistics: 7 env action dims, the state padded to action_dim
    D = cfg.action_dim
    norms = {"action": {"mean": rng.normal(0, 0.1, 7).tolist(), "std": rng.uniform(0.5, 2, 7).tolist()},
             "state": {"mean": rng.normal(0, 0.1, D).tolist(), "std": rng.uniform(0.5, 2, D).tolist()}}
    state = json.dumps(rng.normal(0, 0.5, 8).round(4).tolist())  # an 8-dof robot's state
    views = [_frame_png(seed) for seed in range(3)]
    server = FlowVLAServer(exp, cfg, model, exp.tokenizer.build_tokenizer(), norms,
                           host="127.0.0.1", port=0)
    httpd = server.serve_background()
    port = httpd.server_address[1]
    # one attention call a layer: the prefill, then one per Euler step
    per_call = cfg.llm.num_layers * (1 + cfg.num_flow_steps)
    n_single = 6
    torch.cuda.reset_peak_memory_stats()
    try:
        flash_attention.launches = 0
        attention.plain_cuda_calls = 0
        singles, latencies = [], []
        for _ in range(n_single):
            out, dt = _post(port, PROMPT, views, states=state)
            singles.append(out)
            latencies.append(dt)
        one_view, _ = _post(port, PROMPT, views[:1], states=state)
        batch, batch_dt = _post(port, PROMPT, views + views, batch_size=2, states=f"{state};{state}")
        launches, plain_calls = flash_attention.launches, attention.plain_cuda_calls
    finally:
        httpd.shutdown()
        httpd.server_close()
    peak = torch.cuda.max_memory_allocated() / 2**30
    expected = (n_single + 2) * per_call
    print(f"  launches during serving: K1 {launches} (expected {n_single + 2} device calls x "
          f"{per_call} = {expected}); plain attention calls on CUDA {plain_calls}")
    shapes = [o.shape for o in singles + [one_view]] + [batch.shape[1:]]
    if any(sh != (cfg.chunk_size, 7) for sh in shapes) or batch.shape[0] != 2:
        failures.append(f"pi0 response shapes {set(shapes)}, batch {batch.shape}")
    if not all(np.isfinite(o).all() for o in singles + [one_view, batch]):
        failures.append("pi0: a non-finite action")
    if launches != expected:
        failures.append(f"pi0: K1 launched {launches} times, expected {expected}")
    if plain_calls:
        failures.append(f"pi0: {plain_calls} attention calls of the decoder or the expert "
                        "took the plain path")
    lat = sorted(x * 1e3 for x in latencies[1:])
    p50, p90 = statistics.median(lat), float(np.percentile(lat, 90))
    print(f"  request latency ms over {len(lat)} after the first ({latencies[0] * 1e3:.1f}): "
          f"p50 {p50:.1f}, p90 {p90:.1f}; batch_size=2 {batch_dt * 1e3:.1f}; peak memory "
          f"allocated {peak:.2f} GiB")

    # one request's inputs by hand: the kernel path, the plain path, the parts
    ids = np.zeros((1, 64), np.int32)
    row = server._prompt_ids(PROMPT)
    ids[0, : len(row)] = row
    ids_t = torch.from_numpy(ids).cuda()
    text_mask = (ids_t != 0).to(torch.int32)
    frames, order = _decode_frames(views)
    imgs = torch.from_numpy(preprocess_images_batch(
        frames, exp.data.build_image_processor(), channel_order=order))[None].cuda()
    masks = torch.ones((1, 3), dtype=torch.int32, device=ids_t.device)
    states = torch.from_numpy(server.stats.normalize("state", server._parse_state(state, D)[None])).cuda()
    noise = torch.randn((1, cfg.chunk_size, cfg.action_dim),
                        generator=torch.Generator(device="cuda").manual_seed(13), device="cuda")
    args = (ids_t, text_mask, imgs, masks, states)
    plain_cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, attn_impl="xla"),
                                    expert=dataclasses.replace(cfg.expert, attn_impl="xla"))
    # the residual stream, norms, MLPs and cache in fp32, as the JAX package
    # computes them; the plain path is fp32 throughout, the kernel path
    # rounds only K1's q/k/v to bf16
    with torch.no_grad():
        act_dtype = fv.embed_prefix(model, cfg, imgs, masks, ids_t, text_mask)[0].dtype
    if act_dtype != torch.float32:
        failures.append(f"pi0: the prefix is embedded in {act_dtype}, not the images' fp32")
    a = fv.flow_vla_inference_action(model, cfg, *args, noise=noise)
    n0 = flash_attention.launches
    b = fv.flow_vla_inference_action(model, plain_cfg, *args, noise=noise)
    cos = _cosine(a.flatten(), b.flatten())
    vcos = _cosine((a - noise).flatten(), (b - noise).flatten())
    print(f"  activations {act_dtype}; kernel path (K1 in bf16) vs fp32 plain path: max abs "
          f"diff {(a - b).abs().max().item():.5g}, chunk cosine {cos:.6f}, cosine of the "
          f"integrated velocity {vcos:.6f}, |chunk| max "
          f"{b.abs().max().item():.4g}")
    if flash_attention.launches != n0:
        failures.append("pi0: the plain path launched K1")
    if not (cos >= 0.99 and vcos >= 0.99):
        failures.append(f"pi0 chunk cosine {cos} / velocity cosine {vcos} < 0.99")

    calls = part_calls(model, cfg, *args, noise)
    parts = {f"{part}_ms": ms for part, (ms,) in
             split_parts({name: (wall_ms(fn, reps=PART_REPS),)
                          for name, fn in calls.items()}).items()}
    t_call = parts["device_call_ms"]
    _, q, k, v, ints = pi0_attn_inputs(1, 64, "suffix", torch.Generator(device="cuda").manual_seed(14))
    for _ in range(5):
        flash_attention_fwd(q, k, v, *ints)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(100):
        flash_attention_fwd(q, k, v, *ints)
    host_ms = (time.perf_counter() - t) * 10
    torch.cuda.synchronize()
    print(f"  device path (CUDA-synchronised wall clock, medians of {PART_REPS}): ViT + projector (and the "
          f"text embedding) {parts['vit_projector_ms']:.2f} ms, prefill {parts['prefill_ms']:.2f} ms "
          f"({cfg.llm.num_layers} layers), {cfg.num_flow_steps} Euler steps "
          f"{parts['euler_steps_ms']:.2f} ms, whole call {t_call:.2f} ms; K1 wrapper host time "
          f"{host_ms:.4f} ms a call (suffix shape)")
    del server, b, q, k, v
    free_memory()
    # the model, its chunk and one request's inputs, for phase 5f
    return {"launches": launches, "launches_per_call": per_call, "plain_cuda_calls": plain_calls,
            "p50_ms": p50, "p90_ms": p90, "batch2_ms": batch_dt * 1e3, "peak_gib": peak,
            "cosine": cos, "velocity_cosine": vcos, "k1_host_ms": host_ms, **parts,
            "model": model, "cfg": cfg, "chunk": a, "inputs": args, "noise": noise,
            "norms": norms, "state": state, "views": views}


ROUTE_SINGLES, ROUTE_EIGHTS = 6, 4  # 5d's requests a route, the first of each not timed


def _route_latencies(port: int, png: bytes) -> dict:
    """ROUTE_SINGLES single-frame requests and ROUTE_EIGHTS 8-frame ones; ms
    of each after the first."""
    one = [_post(port, PROMPT, [png])[1] * 1e3 for _ in range(ROUTE_SINGLES)]
    eight = [_post(port, ";".join([PROMPT] * 8), [png] * 8, batch_size=8)[1] * 1e3
             for _ in range(ROUTE_EIGHTS)]
    out = {}
    for label, lat in (("1", one[1:]), ("8", eight[1:])):
        out[f"p50_{label}_ms"] = statistics.median(lat)
        out[f"p90_{label}_ms"] = float(np.percentile(lat, 90))
    return out


def phase_fused_preprocess(failures: list, serve: dict) -> dict:
    """Phase 5d: phase 5's CogACT-7B served with on-device preprocessing
    (CogActServer(fuse_preprocess=True)) and by the host path on the same
    480x640 PNG, single frames and 8-frame requests: the two routes' pixels
    (<= 2 uint8 quanta) and chunks on the same noise (cosine >= 0.99), each
    route's latency, the host preprocessing the fused route removes, the
    route counters, and one request sequence through the robot client."""
    from dexbotic_tpu_torch.client import DexClient
    from dexbotic_tpu_torch.exp.serve import CogActServer, _cogact_images, _decode_frames
    from dexbotic_tpu_torch.models.cogact import cogact_inference_action
    from dexbotic_tpu_torch.ops.attention import attention, flash_attention
    from dexbotic_tpu_torch.ops.dit_fused import fused_dit_sample
    from script.profile_pi0_torch import wall_ms

    print("phase 5d: CogACT-7B with on-device preprocessing (fuse_preprocess) beside the host path")
    exp, cfg, model, tok = serve["exp"], serve["cfg"], serve["model"], serve["tokenizer"]
    proc = exp.data.build_image_processor()
    png = _frame_png()
    servers = {route: CogActServer(exp, cfg, model, tok, None, host="127.0.0.1", port=0,
                                   fuse_preprocess=route == "fused") for route in ("host", "fused")}
    fused = servers["fused"]
    frames, order = _decode_frames([png])
    dev_imgs = fused.device_images(frames, order, 1)
    host_imgs = torch.from_numpy(_cogact_images([png], proc))[None].cuda()
    std = torch.tensor(proc.std, device="cuda")
    quanta = ((dev_imgs - host_imgs).abs() * std / proc.rescale).max().item()
    ids, valid, _, noise = serve["inputs"]
    a = cogact_inference_action(model, cfg, ids, valid, dev_imgs, noise=noise).flatten()
    b = cogact_inference_action(model, cfg, ids, valid, host_imgs, noise=noise).flatten()
    cos = _cosine(a, b)
    print(f"  frame {frames[0].shape[1]}x{frames[0].shape[0]} ({order}) -> {proc.size}: pixels of "
          f"the two routes within {quanta:.4f} uint8 quanta; chunks on the same noise: max abs "
          f"diff {(a - b).abs().max().item():.5g}, cosine {cos:.6f}")
    if not quanta <= 2.0:
        failures.append(f"5d: device pixels {quanta} quanta from the host path's (> 2)")
    if not cos >= 0.99:
        failures.append(f"5d: fused vs host chunk cosine {cos} < 0.99")

    prep = {}
    for n in (1, 8):
        pngs = [png] * n
        prep[f"host_preprocess_{n}_ms"] = wall_ms(lambda: _cogact_images(pngs, proc), reps=10)
        prep[f"device_preprocess_{n}_ms"] = wall_ms(
            lambda: fused.device_images(*_decode_frames(pngs), 1), reps=10)
    print("  preprocessing, median of 10 (decode included; device: CUDA-synchronised): "
          + "; ".join(f"{n} frame(s) host {prep[f'host_preprocess_{n}_ms']:.2f} ms, on the device "
                      f"{prep[f'device_preprocess_{n}_ms']:.2f} ms" for n in (1, 8)))

    lat, counts, client = {}, {}, {}
    for route in ("host", "fused"):
        server = servers[route]
        server.fused_calls = server.host_calls = 0
        httpd = server.serve_background()
        port = httpd.server_address[1]
        try:
            if route == "fused":
                flash_attention.launches = fused_dit_sample.launches = 0
                attention.plain_cuda_calls = 0
            lat[route] = _route_latencies(port, png)
            if route == "fused":  # one single-frame sequence through the robot client
                rgb = frames[0][:, :, ::-1].copy() if order == "bgr" else frames[0]
                c = DexClient(url=f"http://127.0.0.1:{port}/process_frame", execute_steps=8)
                before, times, acts = server.fused_calls, [], []
                for _ in range(2 * c.execute_steps):
                    t0 = time.perf_counter()
                    acts.append(c.act(rgb, PROMPT))
                    times.append((time.perf_counter() - t0) * 1e3)
                client = {"acts": len(acts), "requests": server.fused_calls - before,
                          "refill_ms": [times[0], times[c.execute_steps]],
                          "pop_ms": statistics.median(times[1:c.execute_steps])}
                counts = {"flash_fwd": flash_attention.launches,
                          "dit_sample": fused_dit_sample.launches,
                          "plain_cuda_calls": attention.plain_cuda_calls}
                if (any(np.asarray(x).shape != (cfg.action_dim,) for x in acts)
                        or not np.isfinite(np.stack(acts)).all()
                        or client["requests"] != 2):
                    failures.append(f"5d: the client's {len(acts)} actions took "
                                    f"{client['requests']} requests (want 2) or are malformed")
        finally:
            httpd.shutdown()
            httpd.server_close()
    served = ROUTE_SINGLES + ROUTE_EIGHTS + client.get("requests", 0)
    route_calls = {r: (s.fused_calls, s.host_calls) for r, s in servers.items()}
    print(f"  route counters (fused_calls, host_calls): {route_calls}; requests served by each: "
          f"host 16, fused {served}; launches on the fused route: {counts}")
    host_want = (0, ROUTE_SINGLES + ROUTE_EIGHTS)
    if route_calls["fused"] != (served, 0) or route_calls["host"] != host_want:
        failures.append(f"5d: route counters {route_calls}, want fused ({served}, 0), host "
                        f"{host_want}")
    if counts.get("flash_fwd", 0) <= 0 or counts.get("dit_sample", 0) <= 0:
        failures.append(f"5d: the fused route launched {counts}")
    if counts.get("plain_cuda_calls"):
        failures.append(f"5d: {counts['plain_cuda_calls']} plain attention calls on CUDA")
    for route in ("host", "fused"):
        print(f"  {route} route, request ms over HTTP: 1 frame p50 {lat[route]['p50_1_ms']:.2f} "
              f"p90 {lat[route]['p90_1_ms']:.2f}; 8 frames p50 {lat[route]['p50_8_ms']:.2f} "
              f"p90 {lat[route]['p90_8_ms']:.2f}")
    removed = {n: prep[f"host_preprocess_{n}_ms"] - prep[f"device_preprocess_{n}_ms"]
               for n in (1, 8)}
    print(f"  host preprocessing the fused route removes: {removed[1]:.2f} ms at 1 frame, "
          f"{removed[8]:.2f} ms at 8 (host minus device preprocessing); p50 moved "
          f"{lat['host']['p50_1_ms'] - lat['fused']['p50_1_ms']:.2f} / "
          f"{lat['host']['p50_8_ms'] - lat['fused']['p50_8_ms']:.2f} ms; client: {client}")
    return {"max_quanta": quanta, "cosine": cos, "launches": counts, "route_calls": route_calls,
            "latency": lat, **prep, "client": client}


def export_and_replay(failures: list, label: str, policy: str, model, cfg, config: dict) -> tuple:
    """Write ``model`` under the reference's key names as sharded safetensors
    in CKPT_DIR, then load and convert it through
    script/replay_checkpoint_torch.py's functions; the files are deleted.
    Returns (the exp, cfg and model replayed, a dict of the numbers)."""
    import shutil

    from script.replay_checkpoint_torch import build_exp, load_converted

    from dexbotic_tpu_torch.ops.quant import quantized_bytes

    out_dir = os.path.join(CKPT_DIR, policy)
    shutil.rmtree(out_dir, ignore_errors=True)
    t0 = time.perf_counter()
    file_bytes = write_checkpoint(reference_state_dict(model, cfg), out_dir, config=config)
    write_s = time.perf_counter() - t0
    n_files = len([f for f in os.listdir(out_dir) if f.endswith(".safetensors")])
    free_memory()
    try:
        rss0 = host_rss_gib()
        torch.cuda.synchronize()
        dev0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with sampled_host_peak() as rss:
            exp = build_exp(policy, out_dir)
            cfg2, model2, _, times = load_converted(exp)
        peak = rss["peak_gib"]
        dev_peak = torch.cuda.max_memory_allocated() - dev0
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    model_bytes = quantized_bytes(model2)
    theirs = dict(model.named_parameters())
    bad = [n for n, p in model2.named_parameters()
           if n not in theirs or p.dtype != theirs[n].dtype or not torch.equal(p, theirs[n])]
    bad += sorted(set(theirs) - {n for n, _ in model2.named_parameters()})
    numbers = {"file_bytes": file_bytes, "files": n_files, "write_s": write_s, **times,
               "host_rss_before_gib": rss0, "host_peak_rss_gib": peak,
               "peak_over_file_bytes": peak * 2**30 / file_bytes,
               "device_peak_added_gib": dev_peak / 2**30, "model_gib": model_bytes / 2**30,
               "weights_differing": len(bad)}
    print(f"  {label}: {file_bytes / 2**30:.2f} GiB in {n_files} safetensors files (written in "
          f"{write_s:.1f} s); loaded onto the card in {times['load_s']:.2f} s, converted into the "
          f"serving model in {times['convert_s']:.2f} s; host RSS {rss0:.2f} GiB before, peak "
          f"{peak:.2f} GiB while loading ({numbers['peak_over_file_bytes']:.2f}x the file bytes; "
          f"the load added {peak - rss0:.2f} GiB); device memory: the load added a peak of "
          f"{dev_peak / 2**30:.2f} GiB, the model's {model_bytes / 2**30:.2f} GiB and the "
          f"files' {file_bytes / 2**30:.2f} GiB making {(model_bytes + file_bytes) / 2**30:.2f}; "
          f"parameters differing from the exported model: {len(bad)} {bad[:3]}")
    if dev_peak > model_bytes + file_bytes + 2**30:  # a copy of the checkpoint would show here
        failures.append(f"{label}: loading took {dev_peak / 2**30:.2f} GiB of device memory, "
                        f"more than the model and the files ({(model_bytes + file_bytes) / 2**30:.2f})")
    if bad:
        failures.append(f"{label}: {len(bad)} parameters did not come back bit for bit: {bad[:3]}")
    if cfg2 != cfg:
        failures.append(f"{label}: the replayed config differs from the exported model's")
    return exp, cfg2, model2, numbers


def phase_replay_cogact(failures: list, serve: dict) -> dict:
    """Phase 5e: phase 5's CogACT-7B exported under the reference's key names,
    replayed through the replay script's functions: the weights bit for bit,
    and the chunk on phase 5's frame and noise equal to phase 5's."""
    from dexbotic_tpu_torch.models.cogact import cogact_inference_action
    from dexbotic_tpu_torch.ops.attention import attention, flash_attention
    from dexbotic_tpu_torch.ops.dit_fused import fused_dit_sample
    from script.replay_checkpoint_torch import load_image, replay_cogact

    print("phase 5e: CogACT-7B replayed from a reference-layout checkpoint")
    cfg = serve["cfg"]
    exp, cfg2, model2, numbers = export_and_replay(
        failures, "CogACT-7B", "cogact", serve["model"], cfg,
        {"action_dim": cfg.action_dim, "chunk_size": cfg.chunk_size,
         "action_model_type": cfg.action_model_type})
    ids, valid, imgs, noise = serve["inputs"]
    flash_attention.launches = fused_dit_sample.launches = attention.plain_cuda_calls = 0
    a = cogact_inference_action(model2, cfg2, ids, valid, imgs, noise=noise).flatten()
    torch.cuda.synchronize()
    counts = {"flash_fwd": flash_attention.launches, "dit_sample": fused_dit_sample.launches,
              "plain_cuda_calls": attention.plain_cuda_calls}
    diff = (a - serve["chunk"]).abs().max().item()
    chunk, _ = replay_cogact(exp, cfg2, model2, None, load_image(None), PROMPT)
    print(f"  chunk on phase 5's frame and noise: max |delta| against phase 5's {diff:.3g}; "
          f"launches {counts}; the replay script's own frame and noise (RandomState(0)): first "
          f"action {np.array2string(chunk[0], precision=4)}")
    if diff != 0.0:
        failures.append(f"5e: the replayed chunk differs from phase 5's by {diff}")
    if counts["flash_fwd"] <= 0 or counts["dit_sample"] != 1 or counts["plain_cuda_calls"]:
        failures.append(f"5e: the replayed request's launches {counts}")
    if chunk.shape != (cfg.chunk_size, cfg.action_dim) or not np.isfinite(chunk).all():
        failures.append(f"5e: the replay script's chunk {chunk.shape}")
    del model2
    free_memory()
    return {**numbers, "chunk_max_abs_diff": diff, "launches": counts}


def pi0_k4_products(model, cfg, views: int, text_len: int, batch: int = 1) -> dict:
    """{part: quantized products a pi0 request of ``batch`` rows gives K4 by
    the dispatch rule}, counted from the model: the tower's and projector's
    at every view's tokens, the LLM's at the prefix (views x 256 + the text
    bucket), and per Euler step the expert's at the suffix, the action
    projections' and the time MLP's at the action tokens, the state's at one
    row (where the layers are quantized at all: inference_quantize_min_size)."""
    T = cfg.vit.num_output_tokens
    steps = cfg.num_flow_steps
    actions = torch.nn.ModuleList([model.action_in_proj, model.action_out_proj,
                                   model.time_mlp_in, model.time_mlp_out])
    parts = {"vit": (model.vlm.vit.layers, batch * views * cfg.vit.seq_len, 1),
             "projector": (model.vlm.projector, batch * views * T, 1),
             "llm": (model.vlm.llm.layers, batch * (views * T + text_len), 1),
             "expert": (model.expert.layers, batch * cfg.suffix_len, steps),
             "action_and_time": (actions, batch * cfg.chunk_size, steps),
             "state_proj": (getattr(model, "state_proj", torch.nn.Identity()), batch, steps)}
    return {part: calls * quant_route_counts([(mod, rows)])["k4"]
            for part, (mod, rows, calls) in parts.items()}


# Phase 5f: max |delta| between the int8 pi0 chunk with K4 and with the
# dequantize formulation, same request and noise (fp32 activations, TF32
# off).  Both paths are deterministic; an H100 (700 W) reads 4.499e-4 on a
# chunk of max |value| 3.716, and the bound is about twice that.
PI0_INT8_K4_BOUND = 1e-3


def phase_pi0_replay(failures: list, pi0: dict) -> dict:
    """Phase 5f: phase 5c's pi0 exported and replayed through convert_flow_vla
    (the weights bit for bit, the chunk equal), then served with int8
    weights (inference_quantize="int8"): K4's launches per request against
    the dispatch rule's products, K1's launches, no plain attention call on
    CUDA, the chunk's cosine to the bf16 chunk on the same noise, p50 and
    the weight bytes beside bf16's."""
    from dexbotic_tpu_torch.exp.serve import FlowVLAServer
    from dexbotic_tpu_torch.models.flow_vla import flow_vla_inference_action
    from dexbotic_tpu_torch.ops import quant_matmul as qm
    from dexbotic_tpu_torch.ops.attention import attention, flash_attention
    from dexbotic_tpu_torch.ops.quant import quantized_bytes

    print("phase 5f: pi0 replayed from a reference-layout checkpoint, then served with int8 weights")
    cfg, args, noise = pi0["cfg"], pi0["inputs"], pi0["noise"]
    bf16_bytes = quantized_bytes(pi0["model"])
    exp, cfg2, model, numbers = export_and_replay(
        failures, "pi0", "pi0", pi0["model"], cfg,
        {"action_dim": cfg.action_dim, "chunk_size": cfg.chunk_size})
    del pi0["model"]
    free_memory()
    a = flow_vla_inference_action(model, cfg2, *args, noise=noise)
    diff = (a - pi0["chunk"]).abs().max().item()
    print(f"  chunk on phase 5c's request and noise: max |delta| against phase 5c's {diff:.3g}")
    if diff != 0.0:
        failures.append(f"5f: the replayed pi0 chunk differs from phase 5c's by {diff}")

    exp.inference_quantize = "int8"
    exp.quantize_inference_model(model)
    int8_bytes = quantized_bytes(model)
    server = FlowVLAServer(exp, cfg2, model, exp.tokenizer.build_tokenizer(), pi0["norms"],
                           host="127.0.0.1", port=0)
    httpd = server.serve_background()
    port = httpd.server_address[1]
    n_req = 8
    shapes = set()
    try:
        _post(port, PROMPT, pi0["views"], states=pi0["state"])  # warm-up, not counted
        with quant_routes_seen(model, shapes) as seen:
            flash_attention.launches = qm.quant_matmul.launches = attention.plain_cuda_calls = 0
            latencies = [_post(port, PROMPT, pi0["views"], states=pi0["state"])[1] * 1e3
                         for _ in range(n_req)]
            counts = {"flash_fwd": flash_attention.launches,
                      "quant_matmul": qm.quant_matmul.launches,
                      "plain_cuda_calls": attention.plain_cuda_calls}
    finally:
        httpd.shutdown()
        httpd.server_close()
    want = pi0_k4_products(model, cfg2, views=len(pi0["views"]), text_len=args[0].shape[1])
    per_req = counts["quant_matmul"] / n_req
    hooks = seen.routes()["k4"] / n_req
    print(f"  int8 served, {n_req} requests of 3 views + a state: launches {counts}; K4 a request "
          f"{per_req:g}; the rule's products, from the model: {sum(want.values())} {want}; from "
          f"forward hooks: {hooks:g} a request")
    if not per_req == sum(want.values()) == hooks or per_req <= 0:
        failures.append(f"5f: K4 launched {per_req} times a request; the rule gives "
                        f"{sum(want.values())} {want}, the hooks saw {hooks}")
    if counts["flash_fwd"] != n_req * pi0["launches_per_call"] or counts["plain_cuda_calls"]:
        failures.append(f"5f: K1 {counts['flash_fwd']} launches (want "
                        f"{n_req * pi0['launches_per_call']}), "
                        f"{counts['plain_cuda_calls']} plain attention calls on CUDA")
    unchecked = sorted((M, K, N, str(dt)[6:]) for M, K, N, dt in shapes - K4_CHECKED)
    print(f"  K4's shapes in these requests: {len(shapes)}, each held against its plain "
          f"version in phase 4c; not there: {unchecked}")
    if unchecked or not shapes:
        failures.append(f"5f: K4 took shapes that phase 4c does not check: {unchecked}")
    # the same request and noise with K4, then with quant_linear's dequantize
    # formulation (K4 off): the kernel against its plain version on the model
    n0 = qm.quant_matmul.launches
    b = flow_vla_inference_action(model, cfg2, *args, noise=noise)
    k4_on = qm.quant_matmul.launches - n0
    with plain_int8():
        c = flow_vla_inference_action(model, cfg2, *args, noise=noise)
    k4_off = qm.quant_matmul.launches - n0 - k4_on
    k4_diff = (b - c).abs().max().item()
    print(f"  int8 chunk, K4 ({k4_on} launches) vs the dequantize formulation ({k4_off}): max "
          f"|delta| {k4_diff:.4g} (bound {PI0_INT8_K4_BOUND:g}), |chunk| max "
          f"{c.abs().max().item():.4g}")
    if k4_on != per_req or k4_off or not k4_diff <= PI0_INT8_K4_BOUND:
        failures.append(f"5f: int8 chunk with K4 ({k4_on} launches, want {per_req:g}) vs K4 off "
                        f"({k4_off}): max |delta| {k4_diff} (bound {PI0_INT8_K4_BOUND})")
    cos = _cosine(b.flatten(), pi0["chunk"].flatten())
    vcos = _cosine((b - noise).flatten(), (pi0["chunk"] - noise).flatten())
    lat = sorted(latencies)
    p50, p90 = statistics.median(lat), float(np.percentile(lat, 90))
    print(f"  int8 vs bf16 (phase 5c, same weights, request and noise): chunk cosine {cos:.6f}, "
          f"integrated velocity {vcos:.6f}; request p50 {p50:.1f} (p90 {p90:.1f}) vs "
          f"{pi0['p50_ms']:.1f} ms; weights {int8_bytes / 2**30:.2f} vs {bf16_bytes / 2**30:.2f} GiB")
    if not (cos >= 0.99 and np.isfinite(b.cpu().numpy()).all()):
        failures.append(f"5f: int8 vs bf16 pi0 chunk cosine {cos} < 0.99")
    del model, server, a, b, c
    free_memory()
    return {**numbers, "chunk_max_abs_diff": diff, "launches": counts,
            "k4_shapes": len(shapes), "k4_vs_plain_max_abs_diff": k4_diff,
            "k4_per_request": per_req, "k4_rule": want, "cosine": cos, "velocity_cosine": vcos,
            "p50_ms": p50, "p90_ms": p90, "bf16_p50_ms": pi0["p50_ms"],
            "int8_weight_bytes": int8_bytes, "bf16_weight_bytes": bf16_bytes}


# ---------------------------------------------------------------------------
# OFT-7B (phases 5g and 5h): one LLaMA-2-7B + CLIP-L/336 VLM, the heads in turn
# ---------------------------------------------------------------------------

# (route, OFTModelConfig fields): OFTModelConfig's default (L1, chunk 16), the
# LIBERO recipe's L1 (chunk 8, an 8-dim proprio token, the client's state),
# Diffusion (DDIM-10 over the segment against the prompt's cache), Discrete
OFT_ROUTES = [("l1", {}), ("libero_l1", {"chunk_size": 8, "use_proprio": True, "proprio_dim": 8}),
              ("diffusion", {"action_model_type": "Diffusion"}),
              ("discrete", {"action_model_type": "Discrete"})]
OFT_REQUESTS = 4  # timed single-frame requests a route, after one warm-up


def oft_k1_per_request(cfg) -> int:
    """K1 launches of one OFT request: a decoder pass of one attention call a
    layer, and Diffusion's ddim_steps segment passes after its prefill."""
    return cfg.vlm.llm.num_layers * (1 + (cfg.ddim_steps if "Diffusion" in cfg.action_model_type
                                          else 0))


def oft_k4_products(model, cfg, prompt_len: int) -> dict:
    """{part: quantized products one OFT request of one frame gives K4 by the
    dispatch rule}, counted from the model: the tower's, the projector's, the
    LLM's (one pass over prompt + segment; Diffusion: the prompt's prefill,
    then the segment at each DDIM step), the head's (the MLPResNet at the
    chunk's rows, the noisy-action projector at the action tokens, Discrete's
    lm_head at the action tokens, the proprio projector at one row)."""
    vit = cfg.vlm.vit
    vit_layers = vit.num_layers + (vit.select_layer + 1 if vit.select_layer is not None else 0)
    head, llm = model.action_head, model.vlm.llm
    diffusion = "Diffusion" in cfg.action_model_type
    calls = cfg.ddim_steps if diffusion else 1
    parts = {"vit": (model.vlm.vit.layers[:vit_layers], vit.seq_len, 1),
             "projector": (model.vlm.projector, vit.num_output_tokens, 1)}
    if diffusion:
        parts["llm_prefill"] = (llm.layers, prompt_len, 1)
        parts["llm_segment"] = (llm.layers, cfg.segment_len, calls)
        parts["noisy_action_projector"] = (head.noisy_action_projector, cfg.num_action_tokens,
                                           calls)
        parts["noise_predictor"] = (head.noise_predictor, cfg.chunk_size, calls)
    else:
        parts["llm"] = (llm.layers, prompt_len + cfg.segment_len, 1)
    if "L1" in cfg.action_model_type:
        parts["mlp"] = (head.mlp, cfg.chunk_size, 1)
    if "Discrete" in cfg.action_model_type:
        parts["lm_head"] = (llm.lm_head, cfg.num_action_tokens, 1)
    if cfg.use_proprio:
        parts["proprio_projector"] = (head.proprio_projector, 1, calls)
    return {part: n * quant_route_counts([(mod, rows)])["k4"]
            for part, (mod, rows, n) in parts.items()}


@torch.no_grad()
def oft_parts_ms(model, cfg, ids, valid, imgs, states, noise) -> dict:
    """One OFT request's device call by part, each a CUDA-synchronised median
    of 5 (``wall_ms``): the tower and projector, the decoder (L1/Discrete: the
    joint pass over prompt + segment; Diffusion: the prompt's prefill into
    the cache), the head (L1: the MLPResNet; Discrete: lm_head and the argmax;
    Diffusion: the DDIM steps over the segment against the cache) and the
    whole call, with the device's idle share in the whole call (the union of
    the kernels' intervals in a torch.profiler trace)."""
    from dexbotic_tpu_torch.models import oft as om
    from dexbotic_tpu_torch.nn.transformer import lm_logits
    from script.profile_pi0_torch import trace, wall_ms

    B = ids.shape[0]
    prompt = om.prompt_embeds(model, cfg, ids, imgs)
    t = cfg.action_model_type
    skip = int(cfg.use_proprio)
    if "Diffusion" in t:
        cache = om.prefill_prompt(model, cfg, prompt, valid)
        sched = om.schedule(cfg)

        def eps_fn(x, ts):
            seg = om.action_segment(model, cfg, B, prompt.dtype, states, x,
                                    om.sinusoidal_time_encoding(ts, cfg.hidden))
            hid = om.run_with_segment(model, cfg, None, valid, seg, cache=cache)
            return model.action_head.noise_predictor(om._head_input(hid, cfg, skip + 1))

        decoder = lambda: om.prefill_prompt(model, cfg, prompt, valid)  # noqa: E731
        head = lambda: sched.ddim_sample(eps_fn, noise, cfg.ddim_steps)  # noqa: E731
    else:
        seg = om.action_segment(model, cfg, B, prompt.dtype, states)
        decoder = lambda: om.run_with_segment(model, cfg, prompt, valid, seg)  # noqa: E731
        hid = decoder()
        if "L1" in t:
            head = lambda: model.action_head.mlp(om._head_input(hid, cfg, skip))  # noqa: E731
        else:
            head = lambda: lm_logits(model.vlm.llm, cfg.vlm.llm, hid[:, skip:])[  # noqa: E731
                ..., -om.decode_slots(cfg):].argmax(-1)

    def call():
        return om.oft_inference_action(model, cfg, ids, valid, imgs, states=states, noise=noise)

    parts = {"tower_projector_ms": wall_ms(lambda: om.encode_images(model.vlm, cfg.vlm, imgs),
                                           reps=PART_REPS),
             "decoder_ms": wall_ms(decoder, reps=PART_REPS),
             "head_ms": wall_ms(head, reps=PART_REPS), "device_call_ms": wall_ms(call, reps=PART_REPS)}
    busy, n_kernels, _ = trace(call)
    parts.update(device_busy_ms=busy, idle_share=1 - busy / parts["device_call_ms"],
                 kernels=n_kernels)
    return parts


def oft_inputs(exp, cfg, tokenizer, png: bytes, state: list | None):
    """(ids, valid, images, states or None) of one served frame, as OFTServer
    builds them: the prompt in its 64-token bucket, the host-preprocessed frame."""
    from dexbotic_tpu_torch.exp.serve import _cogact_images, _cogact_prompt_ids

    row = _cogact_prompt_ids(exp, cfg, tokenizer, PROMPT)
    L = -(-len(row) // 64) * 64
    ids = torch.zeros((1, L), dtype=torch.int32, device="cuda")
    ids[0, : len(row)] = torch.tensor(row, device="cuda")
    valid = (torch.arange(L, device="cuda") < len(row)).int()[None]
    imgs = torch.from_numpy(_cogact_images([png], exp.data.build_image_processor()))[None].cuda()
    states = None
    if cfg.use_proprio:
        states = torch.zeros((1, cfg.proprio_dim), device="cuda")
        states[0, : len(state)] = torch.tensor(state, device="cuda")
    return ids, valid, imgs, states


def _chunk_agreement(route: str, a: np.ndarray, b: np.ndarray) -> float:
    """Two served chunks' agreement: Discrete's share of equal actions (equal
    bins decode to equal values), the other heads' cosine."""
    if route == "discrete":
        return float(np.mean(a == b))
    return _cosine(torch.from_numpy(a.astype(np.float64)).flatten(),
                   torch.from_numpy(b.astype(np.float64)).flatten())


def _oft_serve(port: int, cfg, png: bytes, state_json: str, n: int) -> tuple[list, list]:
    """(chunks, ms) of ``n`` single-frame requests (a state where the route
    reads one)."""
    outs, lat = [], []
    for _ in range(n):
        out, dt = _post(port, PROMPT, [png], states=state_json if cfg.use_proprio else None)
        outs.append(out)
        lat.append(dt * 1e3)
    return outs, lat


def phase_oft(failures: list) -> dict:
    """Phase 5g: OFT-7B (OFTModelConfig's default: LLaMA-2-7B + CLIP-L/336 +
    mlp2x_gelu, seeded random bf16 weights) built once through
    OFTExp.load_for_inference, its head swapped for each route of
    OFT_ROUTES; each route served through OFTServer's /process_frame (a
    warm-up, OFT_REQUESTS single frames, a batch_size=2 request, four
    concurrent requests micro-batched) with K1's, K3's and K4's launches, K1's
    shapes and the plain attention calls on CUDA counted around them; each
    batched row of a deterministic head (L1, LIBERO L1, Discrete) against the
    single frame's chunk; then the request's chunk through the kernel path
    and the plain path (attn_impl="xla") on the same weights and noise, and
    the device call by part with its idle share."""
    import concurrent.futures

    from dexbotic_tpu_torch.exp import base_exp
    from dexbotic_tpu_torch.exp.oft_exp import OFTExp, OFTModelConfig
    from dexbotic_tpu_torch.exp.serve import OFTServer, _cogact_prompt_ids
    from dexbotic_tpu_torch.models import oft as om
    from dexbotic_tpu_torch.ops import quant_matmul as qm
    from dexbotic_tpu_torch.ops.attention import attention, flash_attention, flash_attention_bwd
    from dexbotic_tpu_torch.ops.quant import quantized_bytes

    print("phase 5g: OFT-7B (LLaMA-2-7B + CLIP-L/336, bf16 weights) served through /process_frame, "
          "the L1, LIBERO L1, Diffusion and Discrete heads in turn")
    exp = OFTExp(model=OFTModelConfig(), data=base_exp.DataConfig(image_processor="clip_336"),
                 device="cuda")
    t0 = time.perf_counter()
    cfg, model, _ = exp.load_for_inference()
    tokenizer = exp.tokenizer.build_tokenizer()
    heads, gen = {}, torch.Generator(device="cuda").manual_seed(21)
    for route, fields in OFT_ROUTES:
        rcfg = dataclasses.replace(exp.model, **fields).build_config()
        head = model.action_head if route == "l1" else om.build_oft_head(
            rcfg, "cuda", seed=22, prepare=exp.prepare_inference_params)
        if hasattr(head, "action_query"):  # zero at init: every query token alike
            with torch.no_grad():
                head.action_query.normal_(0.0, 0.02, generator=gen)
        heads[route] = (rcfg, head)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    head_params = {r: sum(p.numel() for p in h.parameters()) for r, (_, h) in heads.items()}
    print(f"  built {n_params / 1e9:.3f}B params (L1) on the card in {time.perf_counter() - t0:.1f} "
          f"s, heads {head_params}; {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    n_tok = len(_cogact_prompt_ids(exp, cfg, tokenizer, PROMPT))
    if n_tok != OFT_PROMPT_TOKENS:
        failures.append(f"5g: the prompt is {n_tok} tokens; phases 3 and 6 hold K1 and K3 at "
                        f"{OFT_PROMPT_TOKENS}")
    png = _frame_png()
    state = [round(float(x), 4) for x in np.random.default_rng(23).normal(0, 0.5, 8)]
    state_json = json.dumps(state)
    bf16_bytes = quantized_bytes(model)
    results = {"prompt_tokens": n_tok, "bf16_weight_bytes": bf16_bytes, "head_params": head_params}
    total = {"flash_fwd": 0, "flash_bwd": 0, "quant_matmul": 0}
    k1_shapes: set = set()
    for route, _ in OFT_ROUTES:
        rcfg, head = heads[route]
        model.action_head = head
        per_req = oft_k1_per_request(rcfg)
        state_arg = state_json if rcfg.use_proprio else None
        server = OFTServer(exp, rcfg, model, tokenizer, None, host="127.0.0.1", port=0)
        httpd = server.serve_background()
        port = httpd.server_address[1]
        try:
            _oft_serve(port, rcfg, png, state_json, 1)  # warm-up, not counted
            flash_attention.launches = flash_attention_bwd.launches = 0
            qm.quant_matmul.launches = attention.plain_cuda_calls = 0
            with k1_calls(k1_shapes):
                outs, lat = _oft_serve(port, rcfg, png, state_json, OFT_REQUESTS)
                states2 = f"{state_json};{state_json}" if rcfg.use_proprio else None
                batch, batch_dt = _post(port, f"{PROMPT};{PROMPT}", [png, png], batch_size=2,
                                        states=states2)
            launches, plain = flash_attention.launches, attention.plain_cuda_calls
            total["flash_fwd"] += launches
            total["flash_bwd"] += flash_attention_bwd.launches
            total["quant_matmul"] += qm.quant_matmul.launches
        finally:
            httpd.shutdown()
            httpd.server_close()
        want = (OFT_REQUESTS + 1) * per_req
        shape = (rcfg.chunk_size, rcfg.action_dim)
        ok = (all(o.shape == shape and np.isfinite(o).all() for o in outs)
              and batch.shape == (2, *shape) and np.isfinite(batch).all())
        if not ok:
            failures.append(f"5g {route}: response shapes {[o.shape for o in outs]}, {batch.shape}")
        if launches != want or plain:
            failures.append(f"5g {route}: K1 launched {launches} times (want {want}: "
                            f"{OFT_REQUESTS + 1} device calls x {per_req}), {plain} plain "
                            f"attention calls on CUDA")
        lat = sorted(lat)
        row = {"p50_ms": statistics.median(lat), "p90_ms": float(np.percentile(lat, 90)),
               "batch2_ms": batch_dt * 1e3, "k1_per_request": launches / (OFT_REQUESTS + 1),
               "plain_cuda_calls": plain, "segment_tokens": rcfg.segment_len}
        # four concurrent single frames, micro-batched into one padded device call
        mb = OFTServer(exp, rcfg, model, tokenizer, None, host="127.0.0.1", port=0,
                       micro_batch=4, micro_batch_window_ms=50.0)
        mb.save_image_dir = dump_dir = tempfile.mkdtemp(prefix=f"dumps_5g_{route}_")
        dump_s = timed_dumps(mb)
        httpd = mb.serve_background()
        try:
            attention.plain_cuda_calls = 0
            with k1_calls(k1_shapes), concurrent.futures.ThreadPoolExecutor(max_workers=4) as ex:
                mb_outs = list(ex.map(lambda _: _post(httpd.server_address[1], PROMPT, [png],
                                                      states=state_arg), range(4)))
        finally:
            httpd.shutdown()
            httpd.server_close()
            mb.close()  # its worker holds the model
        row["micro_batched_calls"] = mb.batched_calls
        row["micro_batch_ms"] = [dt * 1e3 for _, dt in mb_outs]
        row["dumps"] = check_dumps(f"5g {route} micro-batched", dump_dir,
                                   [([png], o) for o, _ in mb_outs], dump_s, failures)
        shutil.rmtree(dump_dir)
        if (mb.batched_calls < 1 or attention.plain_cuda_calls
                or not all(o.shape == shape and np.isfinite(o).all() for o, _ in mb_outs)):
            failures.append(f"5g {route}: micro-batching: {mb.batched_calls} coalesced calls, "
                            f"{attention.plain_cuda_calls} plain attention calls, shapes "
                            f"{[o.shape for o, _ in mb_outs]}")
        if route != "diffusion":  # deterministic: each row of a batch is the single frame's chunk
            rows_ = [*batch, *(o for o, _ in mb_outs)]
            agree = [_chunk_agreement(route, r, outs[0]) for r in rows_]
            row["batch_rows_vs_single"] = agree
            print(f"  {route}: the batch_size=2 and micro-batched rows vs the single frame's "
                  f"chunk: {'bins agree on' if route == 'discrete' else 'cosine'} "
                  f"{min(agree):.6f} at worst over {len(agree)} rows")
            if not min(agree) >= 0.99:
                failures.append(f"5g {route}: a batched row disagrees with the single frame's "
                                f"chunk: {agree} (want >= 0.99)")
        # the same frame through the kernel path and the plain path, same noise
        ids, valid, imgs, states = oft_inputs(exp, rcfg, tokenizer, png, state)
        noise = torch.randn((1, rcfg.chunk_size, rcfg.action_dim),
                            generator=torch.Generator(device="cuda").manual_seed(24), device="cuda")
        plain_cfg = plain_config(rcfg)
        n0 = flash_attention.launches
        a = om.oft_inference_action(model, rcfg, ids, valid, imgs, states=states, noise=noise)
        b = om.oft_inference_action(model, plain_cfg, ids, valid, imgs, states=states, noise=noise)
        if flash_attention.launches - n0 != per_req:
            failures.append(f"5g {route}: the kernel path launched K1 "
                            f"{flash_attention.launches - n0} times, the plain path must not")
        if route == "discrete":
            agree = (a == b).float().mean().item()
            row["bin_agreement"] = agree
            row["logits"] = om.discrete_bin_logits(model, rcfg, ids, valid, imgs, states)
            print(f"  {route}: kernel vs plain path, bins agree on {agree:.2%} of the "
                  f"{a.numel()} tokens")
            if not agree >= 0.99:
                failures.append(f"5g discrete: bins agree on {agree:.2%} < 99 %")
        else:
            cos = _cosine(a.flatten(), b.flatten())
            row["cosine"] = cos
            print(f"  {route}: kernel vs plain path: max abs diff {(a - b).abs().max().item():.5g}, "
                  f"cosine {cos:.6f}, |chunk| max {b.abs().max().item():.4g}")
            if not cos >= 0.99:
                failures.append(f"5g {route}: chunk cosine {cos} < 0.99")
        row.update(oft_parts_ms(model, rcfg, ids, valid, imgs, states, noise))
        row.update(chunk=a, inputs=(ids, valid, imgs, states), noise=noise)
        print(f"  {route}: {OFT_REQUESTS} requests p50 {row['p50_ms']:.1f} ms, p90 "
              f"{row['p90_ms']:.1f} ms, batch_size=2 {row['batch2_ms']:.1f} ms; K1 {launches} "
              f"launches ({row['k1_per_request']:g} a request, segment {rcfg.segment_len} "
              f"tokens), plain attention calls on CUDA {plain}; device call "
              f"{row['device_call_ms']:.2f} ms = tower {row['tower_projector_ms']:.2f} + decoder "
              f"{row['decoder_ms']:.2f} + head {row['head_ms']:.2f} (medians of {PART_REPS}), device idle "
              f"{row['idle_share']:.1%} of it over {row['kernels']} kernels")
        results[route] = row
    if total["flash_bwd"] or total["quant_matmul"]:
        failures.append(f"5g: bf16 serving launched K3 {total['flash_bwd']} times, K4 "
                        f"{total['quant_matmul']} times")
    unchecked = sorted(k1_shapes - K1_OFT_CHECKED)
    print(f"  K1 shapes served (B, query rows, key rows): {sorted(k1_shapes)}; not held by "
          f"phase 3: {unchecked}")
    if unchecked or not k1_shapes:
        failures.append(f"5g: K1 took shapes that phase 3 does not check: {unchecked}")
    results["launches"] = total
    results["k1_shapes"] = sorted(k1_shapes)
    return {**results, "model": model, "heads": heads, "exp": exp, "tokenizer": tokenizer,
            "png": png, "state_json": state_json}


def phase_oft_int8(failures: list, oft: dict) -> dict:
    """Phase 5h: phase 5g's OFT-7B quantized (inference_quantize="w8a8": int8
    weights, int8 activations from 2048 rows) with each head quantized alike;
    the L1, Diffusion and Discrete routes served (a warm-up, OFT_REQUESTS
    single frames) with K1's, K3's and K4's launches, K1's shapes and the
    plain attention calls counted; K4's launches a request against the dispatch rule's products
    (from the model and from forward hooks); every (rows, K, N, dtype) K4 took
    among phase 4c's cases; the chunk's cosine to 5g's bf16 chunk on the same
    inputs and noise (Discrete: the bin logits' cosine, and the bins' agreement)."""
    from dexbotic_tpu_torch.exp.serve import OFTServer
    from dexbotic_tpu_torch.models import oft as om
    from dexbotic_tpu_torch.ops import quant_matmul as qm
    from dexbotic_tpu_torch.ops.attention import attention, flash_attention, flash_attention_bwd
    from dexbotic_tpu_torch.ops.quant import quantize_model_, quantized_bytes

    print("phase 5h: OFT-7B with inference_quantize='w8a8' (L1, Diffusion, Discrete)")
    exp, model, heads = oft["exp"], oft["model"], oft["heads"]
    exp.inference_quantize = "w8a8"
    model.action_head = heads["l1"][1]
    exp.quantize_inference_model(model)
    for route in ("diffusion", "discrete"):
        quantize_model_(heads[route][1], min_size=exp.inference_quantize_min_size)
    int8_bytes = quantized_bytes(model)
    results = {"int8_weight_bytes": int8_bytes, "bf16_weight_bytes": oft["bf16_weight_bytes"]}
    total = {"flash_fwd": 0, "flash_bwd": 0, "quant_matmul": 0}
    k1_shapes: set = set()
    for route in ("l1", "diffusion", "discrete"):
        rcfg, head = heads[route]
        model.action_head = head
        bf16 = oft[route]
        ids, valid, imgs, states = bf16["inputs"]
        server = OFTServer(exp, rcfg, model, oft["tokenizer"], None, host="127.0.0.1", port=0)
        httpd = server.serve_background()
        port = httpd.server_address[1]
        shapes = set()
        try:
            _oft_serve(port, rcfg, oft["png"], oft["state_json"], 1)  # warm-up, not counted
            with quant_routes_seen(model, shapes) as seen, k1_calls(k1_shapes):
                flash_attention.launches = flash_attention_bwd.launches = 0
                qm.quant_matmul.launches = attention.plain_cuda_calls = 0
                outs, lat = _oft_serve(port, rcfg, oft["png"], oft["state_json"], OFT_REQUESTS)
                counts = {"flash_fwd": flash_attention.launches,
                          "flash_bwd": flash_attention_bwd.launches,
                          "quant_matmul": qm.quant_matmul.launches,
                          "plain_cuda_calls": attention.plain_cuda_calls}
        finally:
            httpd.shutdown()
            httpd.server_close()
        for k in total:
            total[k] += counts[k]
        want = oft_k4_products(model, rcfg, ids.shape[1])
        per_req = counts["quant_matmul"] / OFT_REQUESTS
        hooks = seen.routes()["k4"] / OFT_REQUESTS
        k1_want = OFT_REQUESTS * oft_k1_per_request(rcfg)
        unchecked = sorted((M, K, N, str(dt)[6:]) for M, K, N, dt in shapes - K4_CHECKED)
        if not all(o.shape == (rcfg.chunk_size, rcfg.action_dim) and np.isfinite(o).all()
                   for o in outs):
            failures.append(f"5h {route}: response shapes {[o.shape for o in outs]}")
        if not per_req == sum(want.values()) == hooks or per_req <= 0:
            failures.append(f"5h {route}: K4 launched {per_req} times a request; the rule gives "
                            f"{sum(want.values())} {want}, the hooks saw {hooks}")
        if counts["flash_fwd"] != k1_want or counts["plain_cuda_calls"] or counts["flash_bwd"]:
            failures.append(f"5h {route}: K1 {counts['flash_fwd']} launches (want {k1_want}), "
                            f"K3 {counts['flash_bwd']} (want 0), {counts['plain_cuda_calls']} "
                            f"plain attention calls on CUDA")
        if unchecked or not shapes:
            failures.append(f"5h {route}: K4 took shapes that phase 4c does not check: {unchecked}")
        a = om.oft_inference_action(model, rcfg, ids, valid, imgs, states=states,
                                    noise=bf16["noise"])
        lat = sorted(lat)
        row = {"p50_ms": statistics.median(lat), "p90_ms": float(np.percentile(lat, 90)),
               "bf16_p50_ms": bf16["p50_ms"], "launches": counts, "k4_per_request": per_req,
               "k4_rule": want, "k4_shapes": len(shapes)}
        if route == "discrete":
            logits = om.discrete_bin_logits(model, rcfg, ids, valid, imgs, states)
            row["logits_cosine"] = _cosine(logits.flatten(), bf16["logits"].flatten())
            row["bin_agreement_with_bf16"] = (a == bf16["chunk"]).float().mean().item()
            cos_label = (f"bin logits cosine {row['logits_cosine']:.6f}, bins agree on "
                         f"{row['bin_agreement_with_bf16']:.2%}")
            cos = row["logits_cosine"]
        else:
            cos = row["cosine"] = _cosine(a.flatten(), bf16["chunk"].flatten())
            cos_label = f"chunk cosine {cos:.6f}"
        if not cos >= 0.99:
            failures.append(f"5h {route}: int8 vs bf16 {cos_label} (want >= 0.99)")
        print(f"  {route}: {OFT_REQUESTS} requests p50 {row['p50_ms']:.1f} ms (bf16 "
              f"{bf16['p50_ms']:.1f}), p90 {row['p90_ms']:.1f} ms; launches {counts}; K4 "
              f"{per_req:g} a request (the rule's products {sum(want.values())} {want}, the hooks "
              f"{hooks:g}); {len(shapes)} K4 shapes, not in 4c: {unchecked}; int8 vs bf16 "
              f"(same inputs and noise): {cos_label}")
        results[route] = row
    print(f"  weights {int8_bytes / 2**30:.2f} GiB int8 (L1 head) vs "
          f"{oft['bf16_weight_bytes'] / 2**30:.2f} GiB bf16")
    qm.W8A8_MIN_ROWS = None  # "w8a8" set it for this process
    unchecked = sorted(k1_shapes - K1_OFT_CHECKED)
    if unchecked or not k1_shapes:
        failures.append(f"5h: K1 took shapes that phase 3 does not check: {unchecked}")
    results["launches"] = total
    results["k1_shapes"] = sorted(k1_shapes)
    return results


LIBERO_PROMPT = "put the black bowl in the bottom drawer of the cabinet and close it"


def write_suite(root: str, views: int = 1, name: str = "train", frames: int = 24,
                episodes: int = 3) -> str:
    """A synthetic Dexdata suite of 480x640 PNG frames (``views`` cameras)
    and 7-dof states (``episodes`` episodes of ``frames`` frames; past the
    24th the images repeat); returns its name.  The PNGs are stored without
    compression (the same pixels): zlib's default level took ~0.12 s a
    frame, a minute of every run over the suites' ~560 frames."""
    from PIL import Image

    from dexbotic_tpu_torch.data.registry import register_dataset

    rng = np.random.default_rng(6)
    os.makedirs(root, exist_ok=True)
    yy, xx = np.mgrid[0:480, 0:640].astype(np.int16)
    for e in range(episodes):
        lines = []
        for t in range(frames):
            row = {}
            for c in range(1, views + 1):  # the images' draws first: phase 7's data stays put
                url = f"e{e}f{t % 24}.png" if views == 1 else f"e{e}f{t % 24}c{c}.png"
                if t < 24:
                    img = np.stack([(xx + 9 * t) % 256, (yy + 40 * e) % 256,
                                    (xx + yy) // (4 + c) % 256], -1)
                    img = np.minimum(img + rng.integers(0, 16, img.shape).astype(np.int16),
                                     255).astype(np.uint8)
                    Image.fromarray(img).save(os.path.join(root, url), compress_level=0)
                row[f"images_{c}"] = {"type": "image", "url": url}
            state = np.sin(np.arange(7) * 0.7 + t * 0.2 + e) + 0.01 * rng.standard_normal(7)
            row.update(state=state.tolist(), prompt=LIBERO_PROMPT, is_robot=True)
            lines.append(json.dumps(row))
        with open(os.path.join(root, f"e{e}.jsonl"), "w") as f:
            f.write("\n".join(lines))
    register_dataset({name: {"data_path_prefix": root, "annotations": root, "frequency": 1}},
                     prefix="smoke", meta_data={"non_delta_mask": [6], "periodic_mask": None,
                                                "periodic_range": None})
    return f"smoke_{name}"


def train_exp(dataset: str, out: str, micro: int, accum: int, steps: int):
    """CogACT-7B on the LIBERO recipe
    (playground/benchmarks/libero/libero_cogact.py) with one change, a frozen
    LLM; rows of the recipe's TRAIN_SEQ_LEN tokens."""
    from dexbotic_tpu_torch.exp import base_exp
    from dexbotic_tpu_torch.exp.cogact_exp import CogActExp, CogActModelConfig
    from dexbotic_tpu_torch.exp.optim import OptimizerConfig
    from dexbotic_tpu_torch.exp.trainer import TrainerConfig

    return CogActExp(
        model=CogActModelConfig(),
        data=base_exp.DataConfig(dataset_name=dataset, image_processor="clip_336",
                                 aug_policy="v1"),
        trainer=TrainerConfig(output_dir=out, max_steps=steps, per_device_batch_size=micro,
                              gradient_accumulation_steps=accum, logging_steps=1,
                              save_steps=steps, bf16=True, gradient_checkpointing=True,
                              resume=False),
        optimizer=OptimizerConfig(learning_rate=2e-5, max_grad_norm=1.0, warmup_ratio=0.03,
                                  lr_scheduler_type="cosine", freeze_llm=True,
                                  freeze_mm_vision=True),
        device="cuda",
    )


@contextlib.contextmanager
def working_dir(path: str):
    prev = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(prev)


def _cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    return torch.nn.functional.cosine_similarity(a, b, dim=0).item()


def phase_train_compare(failures: list, dataset: str) -> None:
    from dexbotic_tpu_torch.data.collator import Collator
    from dexbotic_tpu_torch.exp.trainer import Trainer
    from dexbotic_tpu_torch.models.cogact import cogact_loss
    from dexbotic_tpu_torch.ops.attention import flash_attention_bwd

    print("phase 7a: one training step, kernel path vs plain path (micro-batch 2)")
    exp = train_exp(dataset, "out_compare", 2, 1, 1)
    exp._auto_compute_norm_stats()
    tok = exp.tokenizer.build_tokenizer()
    cfg, model, _ = exp.build_model(tok)
    redraw_final_(model.action_head, torch.Generator(device="cuda").manual_seed(8))
    ds = exp.data.build_data(exp.build_tokenization(tok), exp.action.build_action_process_func())
    n_tok, seq_len = max(len(ds[i]["input_ids"]) for i in range(len(ds))), exp.tokenizer.model_max_length
    samples = [ds[i] for i in (0, 5)]
    batch = Collator(pad_token_id=tok.pad_token_id, max_length=seq_len)(samples)
    print(f"  samples of up to {n_tok} tokens, padded to {seq_len}")
    if (n_tok, seq_len) != (TRAIN_TOKENS, TRAIN_SEQ_LEN):
        failures.append(f"samples of {n_tok} tokens padded to {seq_len}: phases 3 and 6 check "
                        f"K1 and K3 at {TRAIN_TOKENS} of {TRAIN_SEQ_LEN}")
    g = torch.Generator(device="cuda").manual_seed(9)
    rows = cfg.repeated_diffusion_steps * 2
    t = torch.randint(0, cfg.diffusion_steps, (rows,), generator=g, device="cuda")
    noise = torch.randn((rows, cfg.chunk_size, cfg.action_dim), generator=g, device="cuda")
    cfg_plain = plain_config(cfg)
    watched = {"projector": "vlm.projector.", "dit": "action_head."}
    results = {}
    for label, c in (("plain", cfg_plain), ("kernel", cfg)):
        def loss_fn(m, b, gen, c=c):
            return cogact_loss(m, c, b, gen, remat=True, diffusion_t=t, diffusion_noise=noise)

        trainer = Trainer(loss_fn, model, exp.trainer, exp.optimizer)
        start = {n: trainer.params[n].detach().clone() for n in trainer.optimizer.mu}
        flash_attention_bwd.launches = 0
        loss, metrics = trainer.accumulate_grads(batch)
        grads = {k: torch.cat([p.grad.float().flatten() for n, p in trainer.params.items()
                               if n.startswith(prefix) and p.grad is not None])
                 for k, prefix in watched.items()}
        norm = trainer.apply_gradients()
        with torch.no_grad():
            for n, value in start.items():
                trainer.params[n].copy_(value)
        results[label] = (float(loss), float(norm), grads, flash_attention_bwd.launches)
        del trainer, start
    (lp, np_, gp, kp), (lk, nk, gk, kk) = results["plain"], results["kernel"]
    rel_loss, rel_norm = abs(lk - lp) / abs(lp), abs(nk - np_) / abs(np_)
    cos = {k: _cosine(gk[k], gp[k]) for k in watched}
    print(f"  loss kernel {lk:.6g} plain {lp:.6g} (rel {rel_loss:.3g}); grad_norm kernel {nk:.6g} "
          f"plain {np_:.6g} (rel {rel_norm:.3g}); gradient cosine {cos}; K3 launches "
          f"kernel path {kk}, plain path {kp}")
    checks = [(math.isfinite(lk) and rel_loss <= 1e-2, f"loss rel diff {rel_loss} > 1e-2"),
              (math.isfinite(nk) and rel_norm <= 2e-2, f"grad_norm rel diff {rel_norm} > 2e-2"),
              (min(cos.values()) >= 0.99, f"gradient cosine {cos} < 0.99"),
              (kk >= cfg.vlm.llm.num_layers and kp == 0, f"K3 launches {kk} / plain {kp}")]
    failures.extend(msg for ok, msg in checks if not ok)
    del model, results, gp, gk
    free_memory()


def phase_train_steps(failures: list, dataset: str) -> dict:
    from dexbotic_tpu_torch.exp.trainer import Trainer
    from dexbotic_tpu_torch.ops.attention import flash_attention, flash_attention_bwd

    micro, accum, steps = 8, 2, 3
    print(f"phase 7b: {steps} training steps through CogActExp.train() "
          f"(micro-batch {micro}, accumulation {accum})")
    exp = train_exp(dataset, "out_train", micro, accum, steps)
    n_layers = exp.model.build_config().vlm.llm.num_layers
    batches = []  # the host batches, for 7c to replay
    train_step = Trainer.train_step

    def recording(self, batch):
        batches.append(batch)
        return train_step(self, batch)

    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    flash_attention_bwd.launches = 0
    t0 = time.perf_counter()
    Trainer.train_step = recording
    try:
        log = exp.train()
    finally:
        Trainer.train_step = train_step
    wall = time.perf_counter() - t0
    launches = {"flash_fwd": flash_attention.launches, "flash_bwd": flash_attention_bwd.launches}
    with open(os.path.join("out_train", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    for r in rows:
        print(f"  step {r['step']}: loss {r['loss']:.6g} action_loss {r['action_loss']:.6g} "
              f"grad_norm {r['grad_norm']:.6g} step time {1 / r['steps_per_sec']:.4f} s")
    step_s = statistics.median(1 / r["steps_per_sec"] for r in rows[1:])
    rate = micro * accum / step_s
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  train() wall {wall:.1f} s; step time (median of steps 2-{steps}) {step_s:.4f} s, "
          f"{rate:.3f} samples/s; peak memory allocated {peak:.2f} GiB; launches {launches}")
    ckpt = os.path.join("out_train", f"checkpoint-{steps}")
    checks = [(log.get("step") == steps and len(rows) == steps, f"ran {len(rows)} of {steps} steps"),
              (all(math.isfinite(r["loss"]) for r in rows), "non-finite loss"),
              (os.path.exists(os.path.join(ckpt, "norm_stats.json")), f"{ckpt} lacks norm_stats"),
              (launches["flash_bwd"] >= n_layers * accum * steps,
               f"K3 launched {launches['flash_bwd']} < {n_layers * accum * steps} times")]
    failures.extend(msg for ok, msg in checks if not ok)
    return {"launches": launches, "step_s": step_s, "samples_per_s": rate, "peak_gib": peak,
            "rows": rows, "batches": batches, "max_steps": steps, "checkpoint": ckpt}


def checkpoint_layout(path: str) -> dict:
    """{file: {key: (shape, dtype)}} of a checkpoint's params.pt and
    opt_state.pt (the moments under 'mu.' / 'nu.'), read through mmap."""
    out = {}
    for name in ("params.pt", "opt_state.pt"):
        sd = torch.load(os.path.join(path, name), map_location="cpu", weights_only=True, mmap=True)
        if name == "opt_state.pt":
            sd = {**{"mu." + k: v for k, v in sd["mu"].items()},
                  **{"nu." + k: v for k, v in sd["nu"].items()}}
        out[name] = {k: (tuple(v.shape), str(v.dtype)) for k, v in sd.items()}
        del sd
    return out


MESH_STEPS = 2


def phase_train_mesh(failures: list, dataset: str, ref: dict) -> dict:
    """7c: 7b's recipe through CogActExp.train() on the mesh path at world
    size 1 over NCCL; no fallback: a group that does not come up, or a
    Trainer off the mesh path, fails the phase."""
    import torch.distributed as dist

    from dexbotic_tpu_torch.exp.trainer import Trainer
    from dexbotic_tpu_torch.ops.attention import flash_attention, flash_attention_bwd
    from dexbotic_tpu_torch.parallel import multihost

    micro, accum, steps = 8, 2, MESH_STEPS
    print(f"phase 7c: {steps} of 7b's steps through CogActExp.train() on the mesh path "
          f"(a process group of one over NCCL, a 1 x 1 mesh whose leaves are all replicated, "
          f"as the FSDP rule says at data size 1; 7b's batches and schedule)")
    t0 = time.perf_counter()
    group_of_one()
    init_s = time.perf_counter() - t0
    backend = dist.get_backend()
    exp = train_exp(dataset, "out_mesh", micro, accum, ref["max_steps"])
    n_layers = exp.model.build_config().vlm.llm.num_layers
    seen: dict = {}
    train = Trainer.train

    def replay(self, data_iter, max_steps=None):
        seen["mesh"] = self.mesh is not None and self.sharded is not None
        if self.sharded is not None:
            seen["groups"] = {str(d): len(n) for d, n in self.sharded.groups.items()}
            seen["layer_groups"] = len(self.sharded.layers)
            seen["replicated"] = len(self.sharded.replicated)
        return train(self, iter(ref["batches"][:steps]), max_steps=steps)

    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    flash_attention_bwd.launches = 0
    t0 = time.perf_counter()
    Trainer.train = replay
    try:
        exp.train()
    finally:
        Trainer.train = train
        multihost.shutdown()
    wall = time.perf_counter() - t0
    launches = {"flash_fwd": flash_attention.launches, "flash_bwd": flash_attention_bwd.launches}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with open(os.path.join("out_mesh", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    rel = {}
    for r, b in zip(rows, ref["rows"]):
        for k in ("loss", "action_loss", "grad_norm"):
            rel[f"{k}_{r['step']}"] = abs(r[k] - b[k]) / max(abs(b[k]), 1e-30)
        print(f"  step {r['step']}: loss {r['loss']!r} (7b {b['loss']!r}) action_loss "
              f"{r['action_loss']!r} (7b {b['action_loss']!r}) grad_norm {r['grad_norm']!r} "
              f"(7b {b['grad_norm']!r}); step time {1 / r['steps_per_sec']:.4f} s")
    differ = sorted(k for k, v in rel.items() if v)
    step_s = 1 / rows[-1]["steps_per_sec"] if rows else float("nan")
    # 7c replays 7b's batches, so its steps wait on no host decode: compare without the wait
    compute_s = step_s - rows[-1]["data_wait_s"] if rows else float("nan")
    ref_compute_s = statistics.median(1 / r["steps_per_sec"] - r["data_wait_s"]
                                      for r in ref["rows"][1:])
    print(f"  group init {init_s:.2f} s ({backend}); mesh path {seen.get('mesh')}, FSDP2 groups "
          f"{seen.get('groups')} and {seen.get('layer_groups')} a layer, "
          f"{seen.get('replicated')} replicated leaves; train() wall "
          f"{wall:.1f} s; step 2 {step_s:.4f} s against 7b's median {ref['step_s']:.4f} s "
          f"(without the data wait: {compute_s:.4f} s against {ref_compute_s:.4f} s); peak "
          f"{peak:.2f} GiB against 7b's {ref['peak_gib']:.2f} GiB; launches {launches}; rel "
          f"differences from 7b {rel} (not bit-equal: {differ or 'none'})")
    mine = os.path.join("out_mesh", f"checkpoint-{steps}")
    layout, ref_layout = checkpoint_layout(mine), checkpoint_layout(ref["checkpoint"])
    n_bwd = n_layers * accum * steps
    checks = [(backend == "nccl", f"7c: the group's backend is {backend}, not nccl"),
              (seen.get("mesh") is True and seen.get("groups") == {}
               and seen.get("layer_groups") == 0,
               f"7c: the Trainer did not take the mesh path, or sharded at data size 1 "
               f"({seen})"),
              (len(rows) == steps and all(math.isfinite(r["loss"]) for r in rows),
               f"7c: {len(rows)} rows of {steps} steps, or a non-finite loss"),
              (len(rel) == 3 * steps and max(rel.values()) <= 1e-5,
               f"7c: rel differences from 7b {rel} > 1e-5"),
              (launches["flash_bwd"] >= n_bwd and launches["flash_fwd"] >= n_bwd,
               f"7c: launches {launches}, want K3 and K1 >= {n_bwd}"),
              (layout == ref_layout, "7c: checkpoint-2's keys, shapes or dtypes differ from 7b's "
               f"checkpoint-{ref['max_steps']}"),
              (not dist.is_initialized(), "7c: the process group outlived the phase")]
    failures.extend(msg for ok, msg in checks if not ok)
    return {"launches": launches, "step_s": step_s, "ref_step_s": ref["step_s"],
            "compute_s": compute_s, "ref_compute_s": ref_compute_s,
            "peak_gib": peak, "ref_peak_gib": ref["peak_gib"], "rel_from_7b": rel,
            "bit_equal": not differ, "group_init_s": init_s, "train_wall_s": wall,
            "fsdp_groups": seen.get("groups"), "layer_groups": seen.get("layer_groups"),
            "replicated_leaves": seen.get("replicated"),
            "checkpoint_entries": {k: len(v) for k, v in layout.items()}}


def phase_train(failures: list) -> dict:
    """Phase 7 in a temp dir (suite, norm stats, checkpoints), removed after."""
    with tempfile.TemporaryDirectory() as tmp, working_dir(tmp):
        dataset = write_suite(os.path.join(tmp, "suite"))
        phase_train_compare(failures, dataset)
        steps = phase_train_steps(failures, dataset)
        free_memory()
        mesh = phase_train_mesh(failures, dataset, steps)
        for key in ("rows", "batches", "max_steps", "checkpoint"):
            del steps[key]
        return {**steps, "7c_mesh": mesh}


def write_pi0_stats(path: str, dim: int = 32) -> str:
    """pi0-format statistics (mean/std of the action and the state, padded to
    action_dim), seeded, as a user hands them to ``statistic_mapping``."""
    rng = np.random.default_rng(16)
    norms = {key: {"mean": rng.normal(0, 0.1, dim).tolist(), "std": rng.uniform(0.5, 2, dim).tolist()}
             for key in ("action", "state")}
    with open(path, "w") as f:
        json.dump({"norm_stats": norms}, f)
    return path


def pi0_train_exp(dataset: str, stats: str, out: str, micro: int, accum: int, steps: int,
                  save_optimizer: bool = True):
    """pi0 on the LIBERO recipe (playground/benchmarks/libero/libero_pi0.py):
    Pi0Exp's default model at full width and depth, 3 views at siglip_224
    with zero padding and masks, the text padded to 48 tokens, remat, no
    freeze, the default optimizer; ``micro`` x ``accum`` rows a step."""
    from dexbotic_tpu_torch.exp.optim import OptimizerConfig
    from dexbotic_tpu_torch.exp.pi0_exp import Pi0Exp
    from dexbotic_tpu_torch.exp.trainer import TrainerConfig

    base = Pi0Exp()
    return Pi0Exp(
        data=dataclasses.replace(base.data, dataset_name=dataset, image_processor="siglip_224"),
        action=dataclasses.replace(base.action, statistic_mapping=stats),
        trainer=TrainerConfig(output_dir=out, max_steps=steps, per_device_batch_size=micro,
                              gradient_accumulation_steps=accum, logging_steps=1,
                              save_steps=steps, bf16=True, gradient_checkpointing=True,
                              resume=False, save_optimizer=save_optimizer),
        optimizer=OptimizerConfig(),
        device="cuda",
    )


def phase_pi0_train_compare(failures: list, dataset: str, stats: str) -> dict:
    """One pi0 optimizer step (micro-batch 2) through the kernel path and the
    plain path (attn_impl="xla" on the decoder and the expert) on the same
    weights, batch, noise and flow times; the 26 GB of moments are freed
    between the two."""
    from dexbotic_tpu_torch.data.collator import Collator
    from dexbotic_tpu_torch.exp.trainer import Trainer
    from dexbotic_tpu_torch.models import flow_vla as fv
    from dexbotic_tpu_torch.ops.attention import flash_attention, flash_attention_bwd

    print("phase 8a: one pi0 training step, kernel path vs plain path (micro-batch 2)")
    exp = pi0_train_exp(dataset, stats, "out_pi0_compare", 2, 1, 1)
    tok = exp.tokenizer.build_tokenizer()
    cfg, model, _ = exp.build_model(tok)
    ds = exp.data.build_data(exp.build_tokenization(tok), exp.action.build_action_process_func())
    batch = Collator(pad_token_id=tok.pad_token_id, max_length=exp.tokenizer.model_max_length)(
        [ds[0], ds[len(ds) // 2]])
    n_text = batch["attention_mask"].sum(1).tolist()
    print(f"  rows: images {batch['images'].shape}, masks {batch['image_masks'].tolist()}, "
          f"text tokens {n_text} of {batch['input_ids'].shape[1]}, states {batch['states'].shape}, "
          f"actions {batch['actions'].shape}")
    g = torch.Generator(device="cuda").manual_seed(15)
    noise = torch.randn((2, cfg.chunk_size, cfg.action_dim), generator=g, device="cuda")
    time_ = fv.sample_flow_time(2, g, "cuda")
    plain_cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, attn_impl="xla"),
                                    expert=dataclasses.replace(cfg.expert, attn_impl="xla"))
    watched = {"llm": ("vlm.llm.",), "expert": ("expert.",),
               "action_proj": ("action_in_proj.", "action_out_proj.")}
    prefixes = sum(watched.values(), ())
    results, plain_grads, sums = {}, {}, {k: [0.0, 0.0, 0.0] for k in watched}
    for label, c in (("plain", plain_cfg), ("kernel", cfg)):
        def loss_fn(m, b, gen, c=c):
            b = dict(b)
            b["states"] = b.pop("states", None)
            return fv.flow_vla_loss(m, c, b, gen, remat=True, noise=noise, time=time_)

        trainer = Trainer(loss_fn, model, exp.trainer, exp.optimizer)
        start = {n: trainer.params[n].detach().clone() for n in trainer.optimizer.mu}
        flash_attention.launches = flash_attention_bwd.launches = 0
        loss, _ = trainer.accumulate_grads(batch)
        launches = (flash_attention.launches, flash_attention_bwd.launches)
        with torch.no_grad():
            for n, p in trainer.params.items():
                if not n.startswith(prefixes) or p.grad is None:
                    continue
                if label == "plain":
                    plain_grads[n] = p.grad.detach().clone()
                    continue
                a, b = p.grad.float().flatten(), plain_grads.pop(n).float().flatten()
                key = next(k for k, pre in watched.items() if n.startswith(pre))
                sums[key][0] += torch.dot(a, b).item()
                sums[key][1] += torch.dot(a, a).item()
                sums[key][2] += torch.dot(b, b).item()
        norm = trainer.apply_gradients()
        with torch.no_grad():
            for n, value in start.items():
                trainer.params[n].copy_(value)
        results[label] = (float(loss), float(norm), launches)
        del trainer, start
        free_memory()
    (lp, np_, kp), (lk, nk, kk) = results["plain"], results["kernel"]
    rel_loss, rel_norm = abs(lk - lp) / abs(lp), abs(nk - np_) / abs(np_)
    cos = {k: d / math.sqrt(a * b) if a > 0 and b > 0 else float("nan") for k, (d, a, b) in sums.items()}
    print(f"  loss kernel {lk:.6g} plain {lp:.6g} (rel {rel_loss:.3g}); grad_norm kernel {nk:.6g} "
          f"plain {np_:.6g} (rel {rel_norm:.3g}); gradient cosine {cos}; K1/K3 launches "
          f"kernel path {kk}, plain path {kp}")
    n_layers = cfg.llm.num_layers
    checks = [(math.isfinite(lk) and rel_loss <= 1e-2, f"pi0 loss rel diff {rel_loss} > 1e-2"),
              (math.isfinite(nk) and rel_norm <= 2e-2, f"pi0 grad_norm rel diff {rel_norm} > 2e-2"),
              (all(v >= 0.99 for v in cos.values()), f"pi0 gradient cosine {cos} < 0.99"),
              (kk[1] >= n_layers and kp == (0, 0), f"pi0 K1/K3 launches {kk} / plain {kp}")]
    failures.extend(msg for ok, msg in checks if not ok)
    del model, plain_grads
    free_memory()
    return {"loss": [lk, lp], "grad_norm": [nk, np_], "cosine": cos, "launches": kk}


def phase_pi0_train_steps(failures: list, dataset: str, stats: str) -> dict:
    """Two steps of the recipe through Pi0Exp.train(), K1/K3 and the plain
    CUDA attention calls counted around them.  The checkpoint leaves out the
    optimizer's moments (save_optimizer=False: 26 GB to disk)."""
    from dexbotic_tpu_torch.ops.attention import attention, flash_attention, flash_attention_bwd

    micro, accum, steps = PI0_TRAIN_MICRO, 4, 2
    print(f"phase 8b: {steps} pi0 training steps through Pi0Exp.train() "
          f"(micro-batch {micro}, accumulation {accum}, remat, no freeze)")
    exp = pi0_train_exp(dataset, stats, "out_pi0_train", micro, accum, steps, save_optimizer=False)
    n_layers = exp.model.build_config().llm.num_layers
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = flash_attention_bwd.launches = attention.plain_cuda_calls = 0
    t0 = time.perf_counter()
    log = exp.train()
    wall = time.perf_counter() - t0
    launches = {"flash_fwd": flash_attention.launches, "flash_bwd": flash_attention_bwd.launches}
    plain_calls = attention.plain_cuda_calls
    with open(os.path.join("out_pi0_train", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    for r in rows:
        print(f"  step {r['step']}: loss {r['loss']:.6g} grad_norm {r['grad_norm']:.6g} "
              f"step time {1 / r['steps_per_sec']:.4f} s")
    step_s = statistics.median(1 / r["steps_per_sec"] for r in rows[1:])
    rate = micro * accum / step_s
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  train() wall {wall:.1f} s; step time (median of steps 2-{steps}) {step_s:.4f} s, "
          f"{rate:.3f} samples/s; peak memory allocated {peak:.2f} GiB; launches {launches} "
          f"(expected K3 {n_layers} x {accum} x {steps}, K1 twice that under remat); plain "
          f"attention calls on CUDA {plain_calls}")
    ckpt = os.path.join("out_pi0_train", f"checkpoint-{steps}")
    n_bwd = n_layers * accum * steps
    checks = [(log.get("step") == steps and len(rows) == steps, f"pi0 ran {len(rows)} of {steps} steps"),
              (all(math.isfinite(r["loss"]) for r in rows), "pi0: non-finite loss"),
              (os.path.exists(os.path.join(ckpt, "norm_stats.json")), f"{ckpt} lacks norm_stats"),
              (launches["flash_bwd"] == n_bwd, f"pi0: K3 launched {launches['flash_bwd']} != {n_bwd}"),
              (launches["flash_fwd"] >= 2 * n_bwd, f"pi0: K1 launched {launches['flash_fwd']} < {2 * n_bwd}"),
              (plain_calls == 0, f"pi0: {plain_calls} attention calls took the plain path"),
              (peak < 80, f"pi0 training peak {peak:.2f} GiB >= 80")]
    failures.extend(msg for ok, msg in checks if not ok)
    return {"launches": launches, "step_s": step_s, "samples_per_s": rate, "peak_gib": peak,
            "losses": [r["loss"] for r in rows]}


def phase_pi0_train(failures: list) -> dict:
    """Phase 8 in a temp dir (a 3-view suite, pi0 statistics, checkpoints), removed after."""
    with tempfile.TemporaryDirectory() as tmp, working_dir(tmp):
        # episodes of 60 frames: the recipe's 50-step action chunks need 50
        dataset = write_suite(os.path.join(tmp, "suite"), views=3, name="views3", frames=60)
        stats = write_pi0_stats(os.path.join(tmp, "pi0_norm_stats.json"))
        compare = phase_pi0_train_compare(failures, dataset, stats)
        return {"compare": compare, **phase_pi0_train_steps(failures, dataset, stats)}


def oft_train_exp(dataset: str, out: str, micro: int, steps: int, workers: int = 0):
    """OFT-7B on the LIBERO OFT recipe
    (playground/benchmarks/libero/libero_oft.py: L1, chunk 8, proprio, remat)
    with a frozen LLM (freeze_llm=True; the full fine-tune of 7B waits on
    the parallel layer) and the suite's 7-dof states as its proprio input
    (proprio_dim 7: the recipe's 8 is LIBERO's state width, and the action
    pipeline derives the 7-dof actions from the states); rows of the
    recipe's TRAIN_SEQ_LEN tokens + 57.  ``workers`` > 0 decodes in that many
    forked processes."""
    from dexbotic_tpu_torch.playground.benchmarks.libero.libero_oft import LiberoOFTExp

    exp = LiberoOFTExp(device="cuda")
    exp.model = dataclasses.replace(exp.model, proprio_dim=7)
    exp.data = dataclasses.replace(exp.data, dataset_name=dataset, num_workers=workers,
                                   worker_mode="process")
    exp.trainer = dataclasses.replace(exp.trainer, output_dir=out, max_steps=steps,
                                      per_device_batch_size=micro, logging_steps=1,
                                      save_steps=steps, resume=False, save_optimizer=False)
    exp.optimizer = dataclasses.replace(exp.optimizer, freeze_llm=True)
    return exp


def phase_oft_train_compare(failures: list, dataset: str) -> dict:
    """Phase 9a: one OFT training step (micro-batch 2), kernel path vs plain
    path (attn_impl="xla") on the same weights and batch: loss, grad_norm and
    the cosine of the projector's, the tower's and the head's gradients.
    Then an fp32 witness: the plain path in fp32 on the same weights (the
    bf16 values, exactly) and batch, and each bf16 path's distance from it."""
    from dexbotic_tpu_torch.data.collator import Collator
    from dexbotic_tpu_torch.exp.trainer import Trainer
    from dexbotic_tpu_torch.models.oft import oft_loss
    from dexbotic_tpu_torch.ops.attention import flash_attention_bwd

    print("phase 9a: one OFT training step, kernel path vs plain path (micro-batch 2)")
    exp = oft_train_exp(dataset, "out_oft_compare", 2, 1)
    exp._auto_compute_norm_stats()
    tok = exp.tokenizer.build_tokenizer()
    cfg, model, _ = exp.build_model(tok)
    with torch.no_grad():  # zero at init: every query token alike
        model.action_head.action_query.normal_(
            0.0, 0.02, generator=torch.Generator(device="cuda").manual_seed(25))
    ds = exp.data.build_data(exp.build_tokenization(tok), exp.action.build_action_process_func())
    n_tok = max(len(ds[i]["input_ids"]) for i in range(len(ds)))
    seq_len = exp.tokenizer.model_max_length
    batch = Collator(pad_token_id=tok.pad_token_id, max_length=seq_len)([ds[0], ds[5]])
    print(f"  samples of up to {n_tok} tokens, padded to {seq_len}, then the {cfg.segment_len}-"
          f"token segment: rows of {seq_len + cfg.segment_len}")
    if (n_tok, seq_len, cfg.segment_len) != (TRAIN_TOKENS, TRAIN_SEQ_LEN, OFT_CASES[2][4]):
        failures.append(f"9a: samples of {n_tok} tokens padded to {seq_len} + {cfg.segment_len}: "
                        f"phases 3 and 6 hold K1 and K3 at {OFT_CASES[2][2:5]}")
    cfg_plain = plain_config(cfg)
    watched = {"projector": "vlm.projector.", "vit": "vlm.vit.", "head": "action_head."}
    results = {}
    for label, c in (("plain", cfg_plain), ("kernel", cfg)):
        def loss_fn(m, b, gen, c=c):
            return oft_loss(m, c, b, gen, remat=True)

        trainer = Trainer(loss_fn, model, exp.trainer, exp.optimizer)
        start = {n: trainer.params[n].detach().clone() for n in trainer.optimizer.mu}
        flash_attention_bwd.launches = 0
        loss, _ = trainer.accumulate_grads(batch)
        grads = {k: torch.cat([p.grad.float().flatten() for n, p in trainer.params.items()
                               if n.startswith(prefix) and p.grad is not None])
                 for k, prefix in watched.items()}
        norm = trainer.apply_gradients()
        with torch.no_grad():
            for n, value in start.items():
                trainer.params[n].copy_(value)
        results[label] = (float(loss), float(norm), grads, flash_attention_bwd.launches)
        del trainer, start
    # the fp32 witness (the plain path: K1 and K3 take bf16 alone)
    model.float()
    trainer = Trainer(lambda m, b, gen: oft_loss(m, cfg_plain, b, gen, remat=True), model,
                      dataclasses.replace(exp.trainer, bf16=False), exp.optimizer)
    loss, _ = trainer.accumulate_grads(batch)
    g32 = {k: torch.cat([p.grad.float().flatten() for n, p in trainer.params.items()
                         if n.startswith(prefix) and p.grad is not None])
           for k, prefix in watched.items()}
    l32, n32 = float(loss), float(trainer.apply_gradients())
    del trainer
    (lp, np_, gp, kp), (lk, nk, gk, kk) = results["plain"], results["kernel"]
    rel_loss, rel_norm = abs(lk - lp) / abs(lp), abs(nk - np_) / abs(np_)
    cos = {k: _cosine(gk[k], gp[k]) for k in watched}
    witness = {label: {"loss_rel": abs(lx - l32) / abs(l32), "grad_norm_rel": abs(nx - n32) / n32,
                       "grad_cosine": {k: _cosine(gx[k], g32[k]) for k in watched}}
               for label, (lx, nx, gx, _) in results.items()}
    print(f"  loss kernel {lk:.6g} plain {lp:.6g} (rel {rel_loss:.3g}); grad_norm kernel {nk:.6g} "
          f"plain {np_:.6g} (rel {rel_norm:.3g}); gradient cosine {cos}; K3 launches kernel "
          f"path {kk}, plain path {kp}")
    print(f"  fp32 witness: loss {l32:.6g}, grad_norm {n32:.6g}; each bf16 path's distance from "
          f"it: {witness}")
    checks = [(math.isfinite(lk) and rel_loss <= 1e-2, f"9a: loss rel diff {rel_loss} > 1e-2"),
              (math.isfinite(nk) and rel_norm <= 2e-2, f"9a: grad_norm rel diff {rel_norm} > 2e-2"),
              (min(cos.values()) >= 0.99, f"9a: gradient cosine {cos} < 0.99"),
              (kk >= cfg.vlm.llm.num_layers and kp == 0, f"9a: K3 launches {kk} / plain {kp}")]
    # the kernel path sits no further from the fp32 witness than phase 3's
    # error rule allows beside the plain bf16 path
    distances = {label: (w["loss_rel"], w["grad_norm_rel"], 1 - min(w["grad_cosine"].values()))
                 for label, w in witness.items()}
    for what, dk, dp in zip(("loss rel", "grad_norm rel", "1 - gradient cosine"),
                            distances["kernel"], distances["plain"]):
        checks.append((dk <= 2.0 * dp + 1e-3, f"9a: the kernel path's {what} from the fp32 "
                                               f"witness {dk} > 2 x the plain path's {dp} + 1e-3"))
    failures.extend(msg for ok, msg in checks if not ok)
    del model, results, gp, gk, g32
    free_memory()
    return {"loss_rel": rel_loss, "grad_norm_rel": rel_norm, "grad_cosine": cos,
            "k3_launches": kk, "prompt_tokens": n_tok, "fp32_loss": l32, "fp32_grad_norm": n32,
            "vs_fp32": witness}


def phase_oft_train_steps(failures: list, dataset: str, workers: int) -> dict:
    """Phase 9b: OFT_TRAIN_STEPS steps through OFTExp.train() at the recipe's
    micro-batch, host decode in ``workers`` forked processes (0: in line),
    K1/K3 launches and plain CUDA attention calls counted around them; the
    step time, samples/s, peak memory and the seconds a step waited on its
    batch (the Trainer's data_wait_s), medians of steps 2 on."""
    from dexbotic_tpu_torch.ops import quant_matmul as qm
    from dexbotic_tpu_torch.ops.attention import attention, flash_attention, flash_attention_bwd

    steps, micro = OFT_TRAIN_STEPS, OFT_TRAIN_MICRO
    how = f"{workers} decode processes" if workers else "decode in line"
    print(f"phase 9b: {steps} OFT training steps through OFTExp.train() (micro-batch {micro}, "
          f"{how})")
    out = f"out_oft_{workers}"
    exp = oft_train_exp(dataset, out, micro, steps, workers)
    n_layers = exp.model.build_config().vlm.llm.num_layers
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = flash_attention_bwd.launches = attention.plain_cuda_calls = 0
    qm.quant_matmul.launches = 0
    t0 = time.perf_counter()
    with unwritten_checkpoints() as saves:
        log = exp.train()
    wall = time.perf_counter() - t0
    launches = {"flash_fwd": flash_attention.launches, "flash_bwd": flash_attention_bwd.launches,
                "quant_matmul": qm.quant_matmul.launches,
                "plain_cuda_calls": attention.plain_cuda_calls}
    with open(os.path.join(out, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    for r in rows:
        print(f"  step {r['step']}: loss {r['loss']:.6g} grad_norm {r['grad_norm']:.6g} step time "
              f"{1 / r['steps_per_sec']:.4f} s, waited {r['data_wait_s']:.4f} s on its batch")
    step_s = statistics.median(1 / r["steps_per_sec"] for r in rows[1:])
    wait_s = statistics.median(r["data_wait_s"] for r in rows[1:])
    rate = micro / step_s
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  train() wall {wall:.1f} s; step {step_s:.4f} s (median of steps 2-{steps}), "
          f"{rate:.3f} samples/s, data wait {wait_s:.4f} s a step; peak memory allocated "
          f"{peak:.2f} GiB; launches {launches}")
    checks = [(log.get("step") == steps and len(rows) == steps and saves == [steps],
               f"9b: ran {len(rows)} of {steps} steps, saved at {saves}"),
              (all(math.isfinite(r["loss"]) for r in rows), "9b: non-finite loss"),
              (launches["flash_bwd"] >= n_layers * steps and not launches["plain_cuda_calls"]
               and not launches["quant_matmul"],
               f"9b: launches {launches}, want K3 >= {n_layers * steps}, no K4 launch and no "
               f"plain call")]
    failures.extend(msg for ok, msg in checks if not ok)
    shutil.rmtree(out, ignore_errors=True)
    return {"launches": launches, "step_s": step_s, "samples_per_s": rate,
            "data_wait_s": wait_s, "peak_gib": peak, "workers": workers, "train_wall_s": wall}


OFT_TRAIN_STEPS = 2


def phase_oft_train(failures: list) -> dict:
    """Phase 9 in a temp dir (suite, norm stats, checkpoints), removed after."""
    with tempfile.TemporaryDirectory() as tmp, working_dir(tmp):
        dataset = write_suite(os.path.join(tmp, "suite"), name="oft")
        compare = phase_oft_train_compare(failures, dataset)
        workers = phase_oft_train_steps(failures, dataset, 4)
        free_memory()
        inline = phase_oft_train_steps(failures, dataset, 0)
        return {"compare": compare, "workers": workers, "inline": inline}


# ---------------------------------------------------------------------------
# Phase 10: GRPO post-training (SimpleVLA-RL) of the LIBERO OFT-Discrete actor
# ---------------------------------------------------------------------------

# The decoder depth of phases 10a and 10b.  The actor trains in fp32: its
# weights, gradients and Adam's two moments take 16 bytes a parameter.  A
# LLaMA-2-7B layer holds 202.4M parameters; the embedding, lm_head,
# CLIP-L/336 and the projector 0.59B; so N layers take (0.59 + 0.2024 N) x 16
# GB before activations: 4 layers 22.4 GB, 8 layers 35.3 GB, 16 layers 61.3
# GB (57.1 GiB), all 32 would take 113 GB, more than one card.  2 layers
# (15.9 GB) keep the whole script within its time; 10a holds each path on its
# own old log-probs there and at 4 (script/witness_rl_step_torch.py).
RL_LAYERS = 2
RL_EPISODE_STEPS = 64  # the mock envs' episode and the rollout budget: 8 chunks of 8 steps
# the metrics of one step of train_rl(), as the JAX package's loop reports them
RL_METRICS = {"pg_loss", "clip_frac", "approx_kl", "entropy", "loss", "grad_norm",
              "success_rate", "truncated_frac", "num_rollouts", "mean_chunks_per_episode",
              "timing/gen_s", "timing/filter_s", "timing/update_s", "epoch", "step"}


def rl_exp(layers: int, **rl_data):
    """The LIBERO SimpleVLA-RL twin (OFT-Discrete at LLaMA-2-7B and
    CLIP-L/336 widths, chunk 8 x 7 actions, rollout temperature 1.6, lr 1e-6)
    with ``layers`` decoder layers, on RL_ENVS mock envs (LIBERO's 256 x 256
    camera) in groups of 4, RL_EPISODE_STEPS steps an episode."""
    from dexbotic_tpu_torch.exp.simplevla_rl_exp import RLDataLoaderConfig
    from dexbotic_tpu_torch.models import presets
    from dexbotic_tpu_torch.playground.benchmarks.libero.libero_simplevla_rl import (
        LiberoSimpleVLARLExp,
    )

    exp = LiberoSimpleVLARLExp(device="cuda")
    if layers != presets.LLM_PRESETS[exp.model.llm_preset].num_layers:
        name = f"{exp.model.llm_preset}_{layers}_layers"
        presets.LLM_PRESETS[name] = dataclasses.replace(
            presets.LLM_PRESETS[exp.model.llm_preset], num_layers=layers)
        exp.model = dataclasses.replace(exp.model, llm_preset=name)
    exp.env = dataclasses.replace(exp.env, env_type="mock", num_envs=RL_ENVS,
                                  max_episode_steps=RL_EPISODE_STEPS, obs_dim=(256, 256, 3))
    exp.rl_data = RLDataLoaderConfig(n_samples=4, **rl_data)
    exp.rollout = dataclasses.replace(exp.rollout, max_env_steps=RL_EPISODE_STEPS)
    return exp


def rl_rollout_batch(exp, cfg, model, tokenizer) -> dict:
    """One rollout chunk of RL_ENVS mock envs through the actor (its bins and
    log-probs drawn on the kernel path), as the update's batch on the card:
    the episodes' outcomes set to mixed successes in each group of 4, so that
    every row carries an advantage."""
    from dexbotic_tpu_torch.exp.rl.rl_trainer import (
        collect_rollouts,
        flatten_rollouts,
        prepare_update_batch,
    )
    from dexbotic_tpu_torch.sim_envs.factory import create_env_batch

    envs = create_env_batch("mock", exp.env.task_suite_name, ["task_0"] * RL_ENVS,
                            list(range(RL_ENVS)), list(range(70, 70 + RL_ENVS)), exp.env,
                            threaded=False)
    groups = np.repeat(np.arange(RL_ENVS // 4), 4)
    buf = collect_rollouts(envs, exp._make_actor(cfg, model, tokenizer),
                           dataclasses.replace(exp.rollout, max_env_steps=exp.rollout.chunk_steps),
                           torch.Generator(device="cuda").manual_seed(71), group_index=groups)
    success = np.tile(np.array([1, 0, 1, 0], np.float32), RL_ENVS // 4)
    batch = prepare_update_batch(flatten_rollouts(buf), exp.grpo, RL_ENVS // 4,
                                 episode_success=success, episode_group=groups)
    return {k: v.cuda() for k, v in batch.items()}


@contextlib.contextmanager
def decoder_plain_on_bf16():
    """The decoder's plain attention (``impl="xla"``) of an fp32 model as K1
    and K3 take it there: the plain version of K1 (``flash_attention_ref``,
    its backward by autograd) on q, k, v rounded to bf16, the output rounded
    to bf16 and returned in fp32; the rest of the model, and the vision
    tower's attention, stay fp32."""
    from dexbotic_tpu_torch.nn import transformer
    from dexbotic_tpu_torch.ops.attention import flash_attention_ref

    call = transformer.attention

    def rounded(q, k, v, q_grp, kv_grp, kv_valid, scale=None, impl="auto", q_seg=None,
                kv_seg=None, group=None):
        if impl != "xla" or q.dtype != torch.float32:
            return call(q, k, v, q_grp, kv_grp, kv_valid, scale, impl, q_seg, kv_seg, group)
        out, _ = flash_attention_ref(q.bfloat16(), k.bfloat16(), v.bfloat16(), q_grp, kv_grp,
                                     kv_valid, scale, q_seg, kv_seg)
        return out.float()

    transformer.attention = rounded
    try:
        yield
    finally:
        transformer.attention = call


STEP_PATHS = ("kernel", "plain", "bf16")


def hold_step(label: str, paths: dict, ref: tuple, scalars: dict, checks: list) -> tuple[dict, dict]:
    """10a's rule for one training step.  ``paths`` maps STEP_PATHS to a
    path's (metrics, watched gradients), ``ref`` is the fp32 witness's.
    Each path's distance from the witness: every metric of ``scalars``
    ("abs" or "rel" difference) and the 1-cosine of the worst watched
    gradient.  The kernel path's distance must be <= 2x the plain path's (its
    plain version on the same rounded q, k, v) + 0.25x that of bf16 weights
    (a copy under the Trainer's bf16 rule, nn/core.cast_like_jax_: a reading
    of the same step, the margin for the one draw each scalar is).
    Appends a check for each to ``checks``; returns (distances, bounds)."""
    w32, g32 = ref

    def dist(w, k, how):
        d = abs(w[k] - w32[k])
        return d if how == "abs" else d / abs(w32[k])

    witness = {p: {**{f"{k}_{how}": dist(w, k, how) for k, how in scalars.items()},
                   "grad_cosine": {k: _cosine(g[k], g32[k]) for k in g32}}
               for p, (w, g) in paths.items()}
    print(f"  distance from the fp32 witness: {witness}")
    bounds = {}
    for what in witness["kernel"]:
        dk, dp, db = (witness[p][what] for p in STEP_PATHS)
        if what == "grad_cosine":
            dk, dp, db = (1 - min(d.values()) for d in (dk, dp, db))
        bounds[what] = 2.0 * dp + 0.25 * db
        print(f"  {what}: kernel {dk:.4g}  plain {dp:.4g}  bf16 {db:.4g}  bound "
              f"{bounds[what]:.4g} (margin 0.25 x {db:.4g})  "
              f"{'ok' if dk <= bounds[what] else 'FAIL'}")
        checks.append((dk <= bounds[what], f"{label}: the kernel path's {what} from the fp32 "
                                           f"witness {dk} > 2 x the plain path's {dp} + 0.25 x "
                                           f"the bf16 copy's {db}"))
    return witness, bounds


def recorded_train(exp, out_dir: str, before=None, after=None) -> dict:
    """``exp.train()`` with Trainer.train_step wrapped: ``before(trainer,
    batch)`` gives each step's record, ``after(trainer, batch, record)``
    completes it after the step, and the record gains the step's peak
    memory.  The counts of K1-K4 and of plain CUDA attention calls are set
    to 0 just before the run and read just after, with K1's and K3's shapes.
    The checkpoint is not written (unwritten_checkpoints).  Returns the log,
    the records, the rows of ``out_dir``'s metrics.jsonl (the directory is
    removed after), the launches, the shapes, the wall time and the steps
    the Trainer saved at."""
    from dexbotic_tpu_torch.exp import trainer as trainer_mod

    seen = []
    step = trainer_mod.Trainer.train_step

    def recorded(self, batch):
        torch.cuda.reset_peak_memory_stats()
        row = {} if before is None else before(self, batch)
        out = step(self, batch)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if after is not None:
            after(self, batch, row)
        seen.append({**row, "peak_gib": peak})
        return out

    shapes: set = set()
    bwd_shapes: set = set()
    _zero_counts()
    trainer_mod.Trainer.train_step = recorded
    t0 = time.perf_counter()
    try:
        with k1_calls(shapes), k1_calls(bwd_shapes, "_flash_bwd_cuda"), \
                unwritten_checkpoints() as saves:
            log = exp.train()
    finally:
        trainer_mod.Trainer.train_step = step
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    shutil.rmtree(out_dir, ignore_errors=True)
    return {"log": log, "seen": seen, "rows": rows, "launches": launches,
            "k1_shapes": shapes, "k3_shapes": bwd_shapes, "wall": wall, "saves": saves}


@contextlib.contextmanager
def unwritten_checkpoints():
    """Inside, Trainer.save_checkpoint appends the step it is called at to
    the list yielded and writes nothing.  Phases 7b, 7c and 8b write the
    Trainer's checkpoint and read it back; a later phase's (10-15 GB of
    seeded weights: the host copy, the write and the removal, ~15 s each)
    was read by nothing."""
    from dexbotic_tpu_torch.exp.trainer import Trainer

    steps: list = []
    save = Trainer.save_checkpoint
    Trainer.save_checkpoint = lambda self: steps.append(self.step)
    try:
        yield steps
    finally:
        Trainer.save_checkpoint = save


def seed_rows_(ds, seed: int) -> None:
    """Seed the draws a Dexdata item takes (an episode's last frames redrawn
    from the global ``random``, each image's PixelAug, which draws fresh
    entropy), so that a kernel-vs-plain step holds the same rows in every
    run."""
    import random

    random.seed(seed)
    for fn in ds.image_process_func:
        if getattr(fn, "augmentations", None) is not None:
            fn.augmentations.rng = np.random.default_rng(seed)


def rl_watched(cfg) -> dict:
    """10a's watched parameter groups: {name: parameter-name prefix} of the
    projector, the tower's last layer, lm_head and the decoder's last layer."""
    L, vit = cfg.vlm.llm.num_layers, cfg.vlm.vit
    nv = vit.num_layers + (vit.select_layer + 1 if vit.select_layer is not None else 0)
    return {"projector": "vlm.projector.", "vit_last_layer": f"vlm.vit.layers.{nv - 1}.",
            "lm_head": "vlm.llm.lm_head.", "llm_last_layer": f"vlm.llm.layers.{L - 1}."}


def rl_watched_grads(named_grads, watched: dict) -> dict:
    """{group: the group's gradients flattened into one fp32 vector}."""
    return {k: torch.cat([g.float().flatten() for n, g in named_grads
                          if n.startswith(prefix) and g is not None])
            for k, prefix in watched.items()}


def rl_micro_step(model, cfg, exp, mb: dict, watched: dict) -> tuple[dict, dict]:
    """One GRPO micro-batch through rl_policy_loss and its backward, no
    update: (metrics with the gradients' global norm and the K1/K3 launches,
    the watched groups' gradients); the model is left without gradients."""
    from dexbotic_tpu_torch.exp.optim import global_norm
    from dexbotic_tpu_torch.exp.rl.rl_trainer import rl_policy_loss
    from dexbotic_tpu_torch.ops.attention import flash_attention, flash_attention_bwd

    model.requires_grad_(True)
    n0 = (flash_attention.launches, flash_attention_bwd.launches)
    with torch.enable_grad():
        loss, metrics = rl_policy_loss(model, cfg, exp.grpo, mb, exp.rollout.temperature)
        loss.backward()
    named = [(n, p.grad) for n, p in model.named_parameters()]
    out = {k: float(v.detach()) for k, v in metrics.items()}
    out["grad_norm"] = float(global_norm([g for _, g in named if g is not None]))
    out["launches"] = (flash_attention.launches - n0[0], flash_attention_bwd.launches - n0[1])
    g = rl_watched_grads(named, watched)
    for p in model.parameters():
        p.grad = None
    model.requires_grad_(False)
    return out, g


def print_bf16_rule(label: str, model) -> dict:
    """Print and return the count and elements of the 1-D and 0-d bf16
    parameters of ``model``: what the Trainer's bf16 rule
    (nn/core.cast_like_jax_, JAX's on its tree) casts beyond the matrices, a
    stacked layer's norm scales and biases."""
    ps = [p for p in model.parameters() if p.dtype == torch.bfloat16 and p.ndim < 2]
    n, elems = len(ps), sum(p.numel() for p in ps)
    print(f"  {label}: the bf16 rule (nn/core.cast_like_jax_) casts {n} vectors of "
          f"{elems} elements beyond the matrices")
    return {"bf16_vectors": n, "bf16_vector_elements": elems}


@contextlib.contextmanager
def trainer_rule_printed():
    """Inside, every Trainer made with ``bf16=True`` prints what its dtype
    rule cast beyond the matrices (print_bf16_rule): phases 7-15's steps
    through a Trainer or an exp's train()."""
    from dexbotic_tpu_torch.exp.trainer import Trainer

    init = Trainer.__init__

    def printed(self, loss_fn, model, trainer_config, *args, **kwargs):
        init(self, loss_fn, model, trainer_config, *args, **kwargs)
        if trainer_config.bf16:
            print_bf16_rule("Trainer(bf16=True)", model)

    Trainer.__init__ = printed
    try:
        yield
    finally:
        Trainer.__init__ = init


def trainer_rule_copy(build, cfg, model, label: str) -> tuple:
    """A copy of the fp32 ``model`` on the card, ``build(cfg, "cuda",
    prepare=...)`` under the Trainer's bf16 rule (nn/core.cast_like_jax_,
    applied before the values are copied in), and the rule's reading
    (print_bf16_rule, printed under ``label``)."""
    from dexbotic_tpu_torch.nn.core import cast_like_jax_

    bf = build(cfg, "cuda", prepare=lambda m: cast_like_jax_(m, torch.bfloat16))
    with torch.no_grad():
        for p, q in zip(bf.parameters(), model.parameters()):
            p.copy_(q)
    return bf, print_bf16_rule(label, bf)


def rl_own_old_logp(model, cfg, exp, mb: dict) -> tuple[dict, float]:
    """``mb`` with its old log-probs recomputed by ``model`` under ``cfg``
    (the path's own, no gradient), and their largest gap from the rollout's
    on the valid tokens."""
    from dexbotic_tpu_torch.models.oft import oft_action_log_probs

    with torch.no_grad():
        logp, _ = oft_action_log_probs(model, cfg, mb["input_ids"], mb["prompt_valid"],
                                       mb["images"], mb.get("states"), mb["bins"],
                                       temperature=exp.rollout.temperature)
    logp = logp.float()
    gap = float((logp - mb["old_logp"]).abs()[mb["token_mask"] > 0].max())
    return dict(mb, old_logp=logp), gap


def phase_rl_update_compare(failures: list) -> dict:
    """Phase 10a: one GRPOUpdater micro-step on a rollout batch of the 8 envs
    and the same fp32 weights, through the kernel path (K1, K3 on q, k, v
    rounded to bf16) and the plain path (their plain version on the same
    rounded q, k, v: decoder_plain_on_bf16), each against an fp32 witness
    (the plain attention in fp32): loss, pg_loss, entropy, grad_norm, the
    gradient cosine of the projector, the tower's last layer, lm_head and
    the decoder's last layer.  The kernel path's distance from the witness
    is held to 2x the plain path's + a quarter of the distance that bf16
    weights cost the same step (a copy under the Trainer's bf16 rule on the
    plain attention, a reading).  Then the update, which must move the fp32
    weights.

    Every path takes its own old log-probs: the rollout batch's are
    recomputed on the path (rl_own_old_logp) before its micro-step, as the
    update's first micro-step sees them when the rollout and the update run
    the same weights.  Each path's ratio is then 1, its pg_loss the same,
    and its loss and gradient its own.  With the rollout's log-probs (the
    kernel path's) the kernel path's ratio was exactly 1 and every other
    path's pg_loss was its log-prob gap from the kernel path times the
    advantages: the loss term held the kernel path to the witness's own
    gap.  Holding ``loss - pg_loss`` and pg_loss apart would keep that gap
    in the pg_loss reading; recomputing removes it from every path alike."""
    from dexbotic_tpu_torch.exp.rl.rl_trainer import GRPOUpdater
    from dexbotic_tpu_torch.models.oft import build_oft
    from dexbotic_tpu_torch.ops.attention import flash_attention, flash_attention_bwd

    exp = rl_exp(RL_LAYERS)
    cfg = exp.model.build_config()
    print(f"phase 10a: one GRPO micro-step of the LIBERO OFT-Discrete actor at full width, "
          f"{cfg.vlm.llm.num_layers} of 32 decoder layers, fp32 weights: kernel path vs plain "
          f"path (both on bf16 q, k, v) vs fp32 witness, each on its own old log-probs; bf16 "
          f"weights as a reading")
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2 ** 30  # left by earlier phases
    tok = exp.tokenizer.build_tokenizer()
    model = exp.model.build_params(cfg, "cuda")
    n_params = sum(p.numel() for p in model.parameters())
    mb = rl_rollout_batch(exp, cfg, model, tok)
    L = cfg.vlm.llm.num_layers
    watched = rl_watched(cfg)
    gaps = {}

    def run(m, c, label):
        own, gaps[label] = rl_own_old_logp(m, c, exp, mb)
        return rl_micro_step(m, c, exp, own, watched)

    plain = plain_config(cfg)
    w32, g32 = run(model, plain, "fp32 witness")
    with decoder_plain_on_bf16():
        wpl, gpl = run(model, plain, "plain")
    bf, rule = trainer_rule_copy(build_oft, plain, model, "10a's bf16 copy")
    wbf, gbf = run(bf, plain, "bf16")
    del bf
    free_memory()
    updater = GRPOUpdater(cfg, exp.grpo, model, learning_rate=exp.rl_learning_rate,
                          temperature=exp.rollout.temperature)
    before = {n: p.detach().clone() for n, p in model.named_parameters()
              if n.startswith(tuple(watched.values()))}
    mbk, gaps["kernel"] = rl_own_old_logp(model, cfg, exp, mb)
    n0 = (flash_attention.launches, flash_attention_bwd.launches)
    metrics, grads = updater.grads(model, mbk)
    wk = {k: float(v) for k, v in metrics.items()}
    wk["launches"] = (flash_attention.launches - n0[0], flash_attention_bwd.launches - n0[1])
    gk = rl_watched_grads(grads.items(), watched)
    wk["grad_norm"] = float(updater.apply(model, grads))
    del grads
    with torch.no_grad():
        moved = max(float((p - before[n]).abs().max()) for n, p in model.named_parameters()
                    if n in before)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for label, w in (("kernel", wk), ("plain", wpl), ("bf16", wbf), ("fp32 witness", w32)):
        print(f"  {label}: loss {w['loss']:.6g} pg_loss {w['pg_loss']:.6g} entropy "
              f"{w['entropy']:.6g} grad_norm {w['grad_norm']:.6g} clip_frac {w['clip_frac']:.4g} "
              f"approx_kl {w['approx_kl']:.4g}; K1/K3 launches {w['launches']}; own old "
              f"log-probs at most {gaps[label]:.4g} from the rollout's")
    print(f"  {n_params / 1e9:.3f}B parameters; the update moved the watched fp32 weights by "
          f"{moved:.3g} at most (lr {exp.rl_learning_rate}); peak memory allocated {peak:.2f} GiB "
          f"({held:.2f} GiB of it allocated before the phase)")
    checks = [(all(math.isfinite(v) for k, v in wk.items() if k != "launches"),
               f"10a: non-finite kernel-path metrics {wk}"),
              (moved > 0, "10a: the update left the fp32 weights where they were"),
              (wk["launches"][1] >= L and w32["launches"] == wpl["launches"] == (0, 0)
               == wbf["launches"], f"10a: K1/K3 launches kernel path {wk['launches']}, plain "
                                   f"paths {wpl['launches']} {w32['launches']} {wbf['launches']}")]
    witness, bounds = hold_step("10a", {"kernel": (wk, gk), "plain": (wpl, gpl),
                                        "bf16": (wbf, gbf)}, (w32, g32),
                                {"loss": "abs", "entropy": "rel", "grad_norm": "rel"}, checks)
    failures.extend(msg for ok, msg in checks if not ok)
    del model, updater, before, g32, gpl, gbf, gk, mb, mbk
    free_memory()
    return {"layers": L, "params": n_params, "peak_gib": peak, "held_before_gib": held,
            "max_weight_change": moved, "kernel": wk, "plain": wpl, "bf16": wbf,
            "fp32_witness": w32, "vs_fp32": witness, "bounds": bounds, "old_logp_gap": gaps,
            **rule}


def phase_rl_train(failures: list) -> dict:
    """Phase 10b: SimpleVLARLExp.train_rl() end to end on the card (the
    LIBERO twin at phase 10a's depth, RL_ENVS mock envs, 2 groups of 4, 8
    chunks an episode): one step of schedule="random", then one of
    "epoch".  Per step the loop's timings, rollouts, chunks and the peak
    memory of the step (GRPOUpdater.update wrapped to read it); K1 and K3
    launches, their shapes and the plain attention calls on CUDA read around
    each run; the metrics' keys against the JAX loop's (RL_METRICS)."""
    from dexbotic_tpu_torch.exp.rl import rl_trainer
    from dexbotic_tpu_torch.ops.attention import attention, flash_attention, flash_attention_bwd

    peaks: list = []
    update = rl_trainer.GRPOUpdater.update

    def recorded(self, *args, **kw):
        out = update(self, *args, **kw)
        peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)
        torch.cuda.reset_peak_memory_stats()
        return out

    runs = {}
    rl_trainer.GRPOUpdater.update = recorded
    try:
        for schedule, steps in (("random", 1), ("epoch", 1)):
            exp = rl_exp(RL_LAYERS, schedule=schedule)
            exp.rl_steps_per_epoch = steps
            print(f"phase 10b: SimpleVLARLExp.train_rl(), schedule={schedule!r}, {steps} step(s) "
                  f"of {exp.env.num_envs} mock envs x {exp.rollout.max_env_steps // exp.rollout.chunk_steps} "
                  f"chunks, {exp.model.build_config().vlm.llm.num_layers} decoder layers")
            free_memory()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated() / 2 ** 30  # left by earlier phases
            peaks.clear()
            shapes, k3_shapes = set(), set()
            flash_attention.launches = flash_attention_bwd.launches = 0
            attention.plain_cuda_calls = 0
            t0 = time.perf_counter()
            with k1_calls(shapes), k1_calls(k3_shapes, "_flash_bwd_cuda"):
                model, hist = exp.train_rl()
            wall = time.perf_counter() - t0
            launches = {"flash_fwd": flash_attention.launches,
                        "flash_bwd": flash_attention_bwd.launches,
                        "plain_cuda_calls": attention.plain_cuda_calls}
            del model
            free_memory()
            rows = [{**{k: h[k] for k in ("timing/gen_s", "timing/filter_s", "timing/update_s",
                                          "loss", "pg_loss", "entropy", "grad_norm",
                                          "success_rate", "num_rollouts")},
                     "chunks": int(round(h["mean_chunks_per_episode"] * h["num_rollouts"])),
                     "peak_gib": p} for h, p in zip(hist, peaks)]
            for i, r in enumerate(rows):
                print(f"  step {i}: gen {r['timing/gen_s']:.3f} s, filter {r['timing/filter_s']:.3f} "
                      f"s, update {r['timing/update_s']:.3f} s; {r['num_rollouts']} rollouts, "
                      f"{r['chunks']} chunks; loss {r['loss']:.5g}, success {r['success_rate']:.3g}; "
                      f"peak {r['peak_gib']:.2f} GiB")
            print(f"  train_rl() wall {wall:.1f} s; launches {launches}; K1 shapes {sorted(shapes)}, "
                  f"K3 shapes {sorted(k3_shapes)}; {held:.2f} GiB allocated before the run")
            unchecked = sorted((shapes | k3_shapes) - K1_RL_CHECKED)
            checks = [(len(hist) == steps == len(peaks), f"10b {schedule}: ran {len(hist)} of "
                                                          f"{steps} steps"),
                      (all(set(h) == RL_METRICS for h in hist),
                       f"10b {schedule}: metric keys {[sorted(set(h) ^ RL_METRICS) for h in hist]} "
                       f"differ from the JAX loop's"),
                      (all(math.isfinite(v) for h in hist for v in h.values()),
                       f"10b {schedule}: non-finite metrics"),
                      (launches["flash_fwd"] > 0 and launches["flash_bwd"] > 0
                       and launches["plain_cuda_calls"] == 0, f"10b {schedule}: launches {launches}"),
                      (not unchecked and shapes and k3_shapes,
                       f"10b {schedule}: K1 or K3 took shapes phases 3 and 6 do not hold: "
                       f"{unchecked}")]
            failures.extend(msg for ok, msg in checks if not ok)
            runs[schedule] = {"steps": rows, "launches": launches, "wall_s": wall,
                              "held_before_gib": held,
                              "k1_shapes": sorted(shapes), "k3_shapes": sorted(k3_shapes)}
    finally:
        rl_trainer.GRPOUpdater.update = update
    return runs


@torch.no_grad()
def phase_rl_rollouts(failures: list) -> dict:
    """Phase 10c: the rollout actor (SimpleVLARLExp._make_actor) of the
    32-layer LIBERO OFT-Discrete in bf16 serving weights over RL_ENVS mock
    envs' frames: one chunk call through K1 with its launches and shapes
    counted; the bin logits through the kernel path and the plain path on
    the same inputs (cosine >= 0.999), and each against an fp32 witness
    (the plain path in fp32 on the bf16 weights' values): the kernel path's
    largest logit error no more than 2x the plain path's + 1e-3 (phase 3's
    rule), and every bin where the kernel path's argmax differs from the
    plain path's a near-tie: on the plain path the two bins' logits lie
    within 2x the plain path's own largest logit error of each other, a gap
    its rounding alone can close.  (With random weights 10 % of the
    witness's top-2 gaps are below 0.009 logits, so both bf16 paths flip
    ~3 % of the bins against fp32 and each other: a share of agreement
    cannot tell a kernel fault from rounding.)  The plain path's log-probs
    of the bins the kernel path drew against the drawn log-probs (each
    within 2^-7 of its magnitude + 1e-3: two bf16 ulps); the actor call and
    its device call alone, ms a chunk."""
    from dexbotic_tpu_torch.models import oft as om
    from dexbotic_tpu_torch.ops.attention import attention, flash_attention
    from dexbotic_tpu_torch.sim_envs.factory import create_env_batch
    from script.profile_pi0_torch import wall_ms

    exp = rl_exp(32)
    cfg = exp.model.build_config()
    print(f"phase 10c: GRPO rollouts at full depth ({cfg.vlm.llm.num_layers} layers, bf16 serving "
          f"weights), {RL_ENVS} envs a chunk call")
    model = exp.model.build_params(cfg, "cuda", prepare=exp.prepare_inference_params)
    tok = exp.tokenizer.build_tokenizer()
    envs = create_env_batch("mock", exp.env.task_suite_name, ["task_0"] * RL_ENVS,
                            list(range(RL_ENVS)), list(range(80, 80 + RL_ENVS)), exp.env,
                            threaded=False)
    obs, inst = [e.get_obs() for e in envs], [e.get_instruction() for e in envs]
    actor = exp._make_actor(cfg, model, tok)
    gen = torch.Generator(device="cuda").manual_seed(81)
    shapes: set = set()
    flash_attention.launches = attention.plain_cuda_calls = 0
    with k1_calls(shapes):
        actions, bins, logp, ids, valid, imgs = actor(obs, inst, gen)
        torch.cuda.synchronize()
    launches, plain_calls = flash_attention.launches, attention.plain_cuda_calls
    dev = torch.device("cuda")
    ids_t, valid_t = torch.from_numpy(ids).to(dev), torch.from_numpy(valid).to(dev)
    imgs_t = torch.from_numpy(imgs).to(dev)[:, None]
    T = exp.rollout.temperature
    plain = plain_config(cfg)
    lk = om.discrete_bin_logits(model, cfg, ids_t, valid_t, imgs_t, None, T)
    lp = om.discrete_bin_logits(model, plain, ids_t, valid_t, imgs_t, None, T)
    cos = _cosine(lk.flatten().double(), lp.flatten().double())
    agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
    plain_logp, _ = om.oft_action_log_probs(model, plain, ids_t, valid_t, imgs_t, None, bins,
                                            temperature=T)
    dl = (logp - plain_logp).abs()
    logp_ok = bool((dl <= 2.0 ** -7 * plain_logp.abs() + 1e-3).all())
    actor_ms = wall_ms(lambda: actor(obs, inst, gen), reps=PART_REPS)
    device_call_ms = wall_ms(lambda: om.oft_generate_action(model, cfg, ids_t, valid_t, imgs_t,
                                                            None, gen, temperature=T),
                             reps=PART_REPS)
    model.float()  # the fp32 witness
    lw = om.discrete_bin_logits(model, plain, ids_t, valid_t, imgs_t, None, T)
    off = {label: (x.argmax(-1) != lw.argmax(-1)).float().mean().item()
           for label, x in (("kernel", lk), ("plain", lp))}
    err = {label: (x.float() - lw).abs().max().item() for label, x in (("kernel", lk), ("plain", lp))}
    # each bin the kernel path decides otherwise than the plain path: the
    # plain path's logit of its own choice over the kernel path's choice
    ak, ap = lk.argmax(-1), lp.argmax(-1)
    flips = ak != ap
    flip_gaps = (lp.gather(-1, ap[..., None]) - lp.gather(-1, ak[..., None]))[..., 0][flips].float()
    widest = flip_gaps.max().item() if flips.any() else 0.0
    near_tie = 2.0 * err["plain"]
    top2 = lw.topk(2, dim=-1).values
    gaps = torch.quantile((top2[..., 0] - top2[..., 1]).flatten(),
                          torch.tensor([0.05, 0.1, 0.5], device=dev)).tolist()
    print(f"  prompt {ids.shape[1]} tokens ({int(valid.sum(1).min())} to {int(valid.sum(1).max())} "
          f"valid) + {cfg.segment_len}-slot segment; K1 {launches} launches, shapes "
          f"{sorted(shapes)}, plain attention calls on CUDA {plain_calls}")
    print(f"  kernel vs plain path: bin-logit cosine {cos:.6f}, argmax bins agree on {agree:.2%}, "
          f"log-probs of the drawn bins max |diff| {dl.max().item():.4g} "
          f"({'within' if logp_ok else 'OUTSIDE'} two bf16 ulps); argmax bins off the fp32 "
          f"witness's: kernel {off['kernel']:.2%}, plain {off['plain']:.2%}; the witness's "
          f"top-2 logit gap at its 5 / 10 / 50 % quantiles {[round(x, 5) for x in gaps]}")
    print(f"  largest bin-logit error from the fp32 witness: kernel {err['kernel']:.5g}, plain "
          f"{err['plain']:.5g}; {int(flips.sum())} bins decided otherwise than the plain path, "
          f"their plain-path gaps at most {widest:.5g} (near-tie bound {near_tie:.5g})")
    print(f"  a chunk call: actor {actor_ms:.2f} ms (host preprocessing of {RL_ENVS} frames "
          f"included), device call {device_call_ms:.2f} ms (medians of {PART_REPS})")
    unchecked = sorted(shapes - K1_RL_CHECKED)
    checks = [(cos >= 0.999, f"10c: bin-logit cosine {cos} < 0.999"),
              (err["kernel"] <= 2.0 * err["plain"] + 1e-3,
               f"10c: the kernel path's bin logits lie {err['kernel']} from the fp32 witness's, "
               f"> 2 x the plain path's {err['plain']} + 1e-3"),
              (widest <= near_tie, f"10c: the kernel path decided a bin otherwise than the plain "
                                   f"path across a gap of {widest} > {near_tie}, not a near-tie"),
              (logp_ok, f"10c: log-probs differ by {dl.max().item()}, past two bf16 ulps"),
              (launches == cfg.vlm.llm.num_layers and plain_calls == 0,
               f"10c: K1 launched {launches} times (want {cfg.vlm.llm.num_layers}), "
               f"{plain_calls} plain calls"),
              (not unchecked and shapes, f"10c: K1 took shapes phase 3 does not hold: {unchecked}"),
              (actions.shape == (RL_ENVS, 8, 7) and bool(torch.isfinite(actions).all()),
               f"10c: actions {tuple(actions.shape)}")]
    failures.extend(msg for ok, msg in checks if not ok)
    del model, lk, lp, lw
    free_memory()
    return {"layers": cfg.vlm.llm.num_layers, "launches": launches, "k1_shapes": sorted(shapes),
            "logit_cosine": cos, "argmax_agreement": agree, "argmax_off_fp32": off,
            "logit_err_fp32": err, "flips": int(flips.sum()), "widest_flip_gap": widest,
            "near_tie_bound": near_tie,
            "fp32_top2_gap_quantiles": gaps, "logp_max_abs_diff": dl.max().item(),
            "actor_ms": actor_ms, "device_call_ms": device_call_ms,
            "prompt_tokens": int(ids.shape[1])}


def phase_rl(failures: list) -> dict:
    compare = phase_rl_update_compare(failures)
    train = phase_rl_train(failures)
    rollouts = phase_rl_rollouts(failures)
    return {"10a_update_compare": compare, "10b_train_rl": train, "10c_rollouts": rollouts}


# ---------------------------------------------------------------------------
# Phase 11: MemVLA-7B served with its memory bank
# ---------------------------------------------------------------------------

# One episode of 18 frames (the bank of 16 fills, then consolidates twice),
# then a new episode whose first frame is the first episode's first frame
MEMVLA_EPISODE = ["True"] + ["False"] * 17 + ["True"]
MEMVLA_INT8_REQUESTS = ["True", "False", "False", "False"]


def memvla_inputs(exp, cfg, tokenizer, png: bytes):
    """(ids, valid, images) of one served frame, as MemVLAServer builds them:
    the prompt in its 64-token bucket, the host-preprocessed frame."""
    from dexbotic_tpu_torch.exp.serve import _cogact_images, _cogact_prompt_ids

    row = _cogact_prompt_ids(exp, cfg, tokenizer, PROMPT)
    L = -(-len(row) // 64) * 64
    ids = torch.zeros((1, L), dtype=torch.int32, device="cuda")
    ids[0, : len(row)] = torch.tensor(row, device="cuda")
    valid = (torch.arange(L, device="cuda") < len(row)).int()[None]
    imgs = torch.from_numpy(_cogact_images([png], exp.data.build_image_processor()))[None].cuda()
    return ids, valid, imgs


@torch.no_grad()
def memvla_parts_ms(model, cfg, ids, valid, imgs, state, noise) -> dict:
    """One MemVLA request's device call by part (CUDA-synchronised medians of
    5): the tower and projector, the LLaMA prefill with the SE bottleneck,
    the bank step (both roles' retrieval, fusion and consolidation), the DiT
    sampler (the plain loop of ddim_steps x CFG) and the whole call, with
    the device's idle share in the whole call."""
    from dexbotic_tpu_torch.models import memvla as mm
    from dexbotic_tpu_torch.models.vlm import encode_images
    from script.profile_pi0_torch import trace, wall_ms

    t = torch.full((1,), 5.0, device="cuda")
    per, cog = mm.encode(model, cfg, ids, valid, imgs)
    per_f, cog_f, _ = mm.bank_step(model, cfg, state, per, cog, t)

    def call():
        return mm.memvla_inference_action(model, cfg, ids, valid, imgs, state, t, noise=noise)

    tower = wall_ms(lambda: encode_images(model.vlm, cfg.vlm, imgs), reps=PART_REPS)
    parts = {"tower_projector_ms": tower,
             "prefill_se_ms": wall_ms(lambda: mm.encode(model, cfg, ids, valid, imgs),
                                      reps=PART_REPS) - tower,
             "bank_step_ms": wall_ms(lambda: mm.bank_step(model, cfg, state, per, cog, t),
                                     reps=PART_REPS),
             "dit_sampler_ms": wall_ms(lambda: mm.sample_actions(model, cfg, cog_f, per_f, noise,
                                                                 cfg.cfg_scale), reps=PART_REPS),
             "device_call_ms": wall_ms(call, reps=PART_REPS)}
    busy, n_kernels, _ = trace(call)
    parts.update(device_busy_ms=busy, idle_share=1 - busy / parts["device_call_ms"],
                 kernels=n_kernels)
    return parts


def _memvla_episode(port: int, pngs: list, firsts: list, server) -> tuple[list, list, list]:
    """(chunks, ms, bank counts) of one episode of requests; the server's
    noise is reseeded at each 'True', so that an episode's first frame
    always draws the same noise."""
    chunks, lat, counts = [], [], []
    for i, first in enumerate(firsts):
        if first == "True":
            server.generator.manual_seed(91)
        out, dt = _post(port, PROMPT, [pngs[i]], extra={"episode_first_frame": first})
        chunks.append(out)
        lat.append(dt * 1e3)
        counts.append(int(server.session.state["per"]["count"][0]))
    return chunks, lat, counts


@torch.no_grad()
def memvla_direct(model, cfg, inputs: list, firsts: list, noises: list) -> list:
    """The chunks of an episode through memvla_inference_action, the bank
    carried and reset at each 'True'."""
    from dexbotic_tpu_torch.models import memvla as mm

    state, t, out = mm.init_mem_state(cfg, 1, device="cuda"), 0, []
    for (ids, valid, imgs), first, noise in zip(inputs, firsts, noises):
        if first == "True":
            state, t = mm.reset_mem_rows(state, torch.ones(1, dtype=torch.bool)), 0
        chunk, state = mm.memvla_inference_action(model, cfg, ids, valid, imgs, state,
                                                  torch.full((1,), float(t), device="cuda"),
                                                  noise=noise)
        out.append(chunk)
        t += 1
    return out


def phase_memvla(failures: list) -> dict:
    """Phase 11a: MemVLA-7B (the LIBERO twin: LLaMA-2-7B + CLIP-L/336 +
    DiT-B with memory cross-attention, a bank of 16 consolidated by ToMe,
    seeded bf16 weights, the DiT's zero-initialised final layer and
    cross-attention out-projections redrawn) served over HTTP by
    MemVLAServer: one episode of 18 frames, then a new one (MEMVLA_EPISODE),
    with K1's and K2's launches, K1's shapes and the plain attention calls
    on CUDA read around it; the bank's count after each request; the new
    episode's first chunk against the first episode's (the same frame and
    noise); every chunk of the episode through the kernel path and the plain
    path on the same injected noise; p50/p90 and the device call by part."""
    from dexbotic_tpu_torch.exp.serve import MemVLAServer, _cogact_prompt_ids
    from dexbotic_tpu_torch.ops.attention import attention, flash_attention
    from dexbotic_tpu_torch.ops.dit_fused import fused_dit_sample
    from dexbotic_tpu_torch.ops.quant import quantized_bytes
    from dexbotic_tpu_torch.playground.benchmarks.libero.libero_memvla import LiberoMemVLAExp

    exp = LiberoMemVLAExp(device="cuda")
    t0 = time.perf_counter()
    cfg, model, _ = exp.load_for_inference()
    gen = torch.Generator(device="cuda").manual_seed(90)
    redraw_final_(model.action_head, gen)
    with torch.no_grad():  # zero at init: the memory tokens would not reach the chunk
        for blk in model.action_head.blocks:
            blk.xattn.o.weight.normal_(0.0, 0.02, generator=gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"phase 11a: MemVLA-7B ({n_params / 1e9:.3f}B params, bf16, built in "
          f"{time.perf_counter() - t0:.1f} s) served through MemVLAServer: an episode of "
          f"{len(MEMVLA_EPISODE) - 1} frames with a bank of {cfg.mem_length}, then a new one")
    tok = exp.tokenizer.build_tokenizer()
    n_tok = len(_cogact_prompt_ids(exp, cfg, tok, PROMPT))
    if n_tok != MEMVLA_PREFILL_CASE[2]:
        failures.append(f"11a: the prompt is {n_tok} tokens; phase 3 holds K1 at "
                        f"{MEMVLA_PREFILL_CASE[2]}")
    pngs = [_frame_png(100 + i) for i in range(len(MEMVLA_EPISODE) - 1)]
    pngs.append(pngs[0])  # the new episode starts on the first episode's first frame
    server = MemVLAServer(exp, cfg, model, tok, None, host="127.0.0.1", port=0)
    httpd = server.serve_background()
    port = httpd.server_address[1]
    try:
        _post(port, PROMPT, [pngs[0]], extra={"episode_first_frame": "True"})  # warm-up
        try:
            _post(port, PROMPT, [pngs[0]])
            failures.append("11a: a request without episode_first_frame was served")
        except urllib.error.HTTPError as e:
            if e.code != 500:
                failures.append(f"11a: a request without episode_first_frame gave {e.code}")
        shapes: set = set()
        flash_attention.launches = fused_dit_sample.launches = attention.plain_cuda_calls = 0
        with k1_calls(shapes):
            chunks, lat, counts = _memvla_episode(port, pngs, MEMVLA_EPISODE, server)
        launches = {"flash_fwd": flash_attention.launches,
                    "dit_sample": fused_dit_sample.launches,
                    "plain_cuda_calls": attention.plain_cuda_calls}
    finally:
        httpd.shutdown()
        httpd.server_close()
    n = len(MEMVLA_EPISODE)
    want_counts = [min(i + 1, cfg.mem_length) for i in range(n - 1)] + [1]
    reset_diff = float(np.abs(chunks[-1] - chunks[0]).max())
    per_req = launches["flash_fwd"] / n
    lat_sorted = sorted(lat)
    print(f"  bank counts {counts}; the new episode's first chunk vs the first episode's: max "
          f"|diff| {reset_diff:.3g}; K1 {launches['flash_fwd']} launches ({per_req:g} a request), "
          f"K2 {launches['dit_sample']}, plain attention calls on CUDA "
          f"{launches['plain_cuda_calls']}; K1 shapes {sorted(shapes)}")
    # every chunk of the episode, kernel path vs plain path, on the same injected noise
    inputs = [memvla_inputs(exp, cfg, tok, png) for png in pngs]
    ng = torch.Generator(device="cuda").manual_seed(92)
    noises = [torch.randn((1, cfg.chunk_size, cfg.action_dim), generator=ng, device="cuda")
              for _ in range(n)]
    kernel = memvla_direct(model, cfg, inputs, MEMVLA_EPISODE, noises)
    plain = memvla_direct(model, plain_config(cfg), inputs, MEMVLA_EPISODE, noises)
    cos = [_cosine(a.flatten().double(), b.flatten().double()) for a, b in zip(kernel, plain)]
    print(f"  kernel vs plain path over the episode: chunk cosine {min(cos):.6f} at worst")
    from dexbotic_tpu_torch.models import memvla as mm

    state = mm.init_mem_state(cfg, 1, device="cuda")
    for (ids, valid, imgs), noise in zip(inputs[:cfg.mem_length], noises):  # a full bank
        _, state = mm.memvla_inference_action(model, cfg, ids, valid, imgs, state,
                                              torch.zeros(1, device="cuda"), noise=noise)
    parts = memvla_parts_ms(model, cfg, *inputs[0], state, noises[0])
    row = {"p50_ms": statistics.median(lat_sorted), "p90_ms": float(np.percentile(lat_sorted, 90)),
           "k1_per_request": per_req, "launches": launches, "bank_counts": counts,
           "reset_chunk_max_abs_diff": reset_diff, "kernel_vs_plain_cosine_min": min(cos),
           "prompt_tokens": n_tok, "params": n_params, "bf16_weight_bytes": quantized_bytes(model),
           "k1_shapes": sorted(shapes), **parts}
    print(f"  {n} requests p50 {row['p50_ms']:.1f} ms, p90 {row['p90_ms']:.1f} ms; device call "
          f"{parts['device_call_ms']:.2f} ms = tower {parts['tower_projector_ms']:.2f} + prefill "
          f"and SE {parts['prefill_se_ms']:.2f} + bank step {parts['bank_step_ms']:.2f} + DiT "
          f"sampler {parts['dit_sampler_ms']:.2f} (medians of {PART_REPS}), device idle "
          f"{parts['idle_share']:.1%} of it over {parts['kernels']} kernels")
    unchecked = sorted(shapes - K1_MEMVLA_CHECKED)
    checks = [(counts == want_counts, f"11a: bank counts {counts}, want {want_counts}"),
              (reset_diff <= 1e-6, f"11a: the reset episode's first chunk differs by {reset_diff}"),
              (all(c.shape == (cfg.chunk_size, cfg.action_dim) and np.isfinite(c).all()
                   for c in chunks), "11a: a chunk of another shape or not finite"),
              (launches["flash_fwd"] == n * cfg.vlm.llm.num_layers
               and launches["dit_sample"] == 0 and launches["plain_cuda_calls"] == 0,
               f"11a: launches {launches}, want K1 {n} x {cfg.vlm.llm.num_layers}, no K2 and "
               f"no plain call"),
              (min(cos) >= 0.99, f"11a: kernel vs plain chunk cosine {cos} < 0.99"),
              (not unchecked and shapes, f"11a: K1 took shapes phase 3 does not hold: {unchecked}")]
    failures.extend(msg for ok, msg in checks if not ok)
    return {**row, "model": model, "exp": exp, "cfg": cfg, "tokenizer": tok, "pngs": pngs,
            "inputs": inputs, "noises": noises, "kernel_chunks": kernel}


def phase_memvla_int8(failures: list, mem: dict) -> dict:
    """Phase 11b: phase 11a's MemVLA-7B quantized (inference_quantize="w8a8")
    served the first frames of the same episode (MEMVLA_INT8_REQUESTS): K1's,
    K2's and K4's launches, K4's (rows, K, N, dtype) and the plain attention
    calls read around them, K4's launches against the quantized products
    the forward hooks saw; every K4 shape must be one phase 4c holds; the
    weight bytes; the chunks on 11a's inputs and noise against 11a's bf16
    kernel-path chunks (cosine >= 0.99)."""
    from dexbotic_tpu_torch.exp.serve import MemVLAServer
    from dexbotic_tpu_torch.ops import quant_matmul as qm
    from dexbotic_tpu_torch.ops.attention import attention, flash_attention
    from dexbotic_tpu_torch.ops.dit_fused import fused_dit_sample
    from dexbotic_tpu_torch.ops.quant import quantized_bytes

    exp, cfg, model, tok = mem["exp"], mem["cfg"], mem["model"], mem["tokenizer"]
    print('phase 11b: MemVLA-7B with inference_quantize="w8a8" served through MemVLAServer')
    old_rows = qm.W8A8_MIN_ROWS
    exp.inference_quantize = "w8a8"
    exp.quantize_inference_model(model)
    int8_bytes = quantized_bytes(model)
    server = MemVLAServer(exp, cfg, model, tok, None, host="127.0.0.1", port=0)
    httpd = server.serve_background()
    port = httpd.server_address[1]
    n = len(MEMVLA_INT8_REQUESTS)
    try:
        _post(port, PROMPT, [mem["pngs"][0]], extra={"episode_first_frame": "True"})  # warm-up
        k1s, k4s = set(), set()
        flash_attention.launches = fused_dit_sample.launches = attention.plain_cuda_calls = 0
        qm.quant_matmul.launches = 0
        with k1_calls(k1s), quant_routes_seen(model, k4s) as seen:
            chunks, lat, counts = _memvla_episode(port, mem["pngs"], MEMVLA_INT8_REQUESTS, server)
        launches = {"flash_fwd": flash_attention.launches, "quant_matmul": qm.quant_matmul.launches,
                    "dit_sample": fused_dit_sample.launches,
                    "plain_cuda_calls": attention.plain_cuda_calls}
    finally:
        httpd.shutdown()
        httpd.server_close()
    q = memvla_direct(model, cfg, mem["inputs"][:n], MEMVLA_INT8_REQUESTS, mem["noises"][:n])
    qm.W8A8_MIN_ROWS = old_rows
    cos = [_cosine(a.flatten().double(), b.flatten().double())
           for a, b in zip(q, mem["kernel_chunks"][:n])]
    hooks = seen.routes()["k4"]
    unchecked = sorted(k4s - K4_CHECKED, key=str)
    lat = sorted(lat)
    row = {"p50_ms": statistics.median(lat), "launches": launches,
           "k4_per_request": launches["quant_matmul"] / n, "k4_hook_products": hooks,
           "k4_by_module": seen.k4(), "int8_weight_bytes": int8_bytes,
           "bf16_weight_bytes": mem["bf16_weight_bytes"], "cosine_to_bf16_min": min(cos),
           "bank_counts": counts, "k4_shapes": sorted([list(s[:3]) + [str(s[3])] for s in k4s])}
    print(f"  K4 {launches['quant_matmul']} launches ({row['k4_per_request']:g} a request; the "
          f"hooks saw {hooks} products: {seen}), K1 {launches['flash_fwd']}, K2 "
          f"{launches['dit_sample']}, plain attention calls {launches['plain_cuda_calls']}; weight "
          f"bytes {mem['bf16_weight_bytes'] / 1e9:.3f} GB bf16 -> {int8_bytes / 1e9:.3f} GB; chunk "
          f"cosine to bf16 {min(cos):.6f} at worst; p50 {row['p50_ms']:.1f} ms; K4 shapes not "
          f"held by phase 4c: {unchecked}")
    checks = [(launches["quant_matmul"] == hooks > 0, f"11b: K4 launched "
                                                       f"{launches['quant_matmul']} times, the "
                                                       f"hooks saw {hooks} products"),
              (not unchecked, f"11b: K4 took shapes phase 4c does not hold: {unchecked}"),
              (launches["flash_fwd"] == n * cfg.vlm.llm.num_layers and launches["dit_sample"] == 0
               and launches["plain_cuda_calls"] == 0, f"11b: launches {launches}"),
              (int8_bytes < 0.6 * mem["bf16_weight_bytes"],
               f"11b: {int8_bytes} weight bytes int8 vs {mem['bf16_weight_bytes']} bf16"),
              (min(cos) >= 0.99, f"11b: int8 vs bf16 chunk cosine {cos} < 0.99"),
              (counts == [1, 2, 3, 4], f"11b: bank counts {counts}"),
              (all(np.isfinite(c).all() for c in chunks), "11b: a chunk is not finite"),
              (not sorted(k1s - K1_MEMVLA_CHECKED), f"11b: K1 shapes {sorted(k1s)}")]
    failures.extend(msg for ok, msg in checks if not ok)
    return row


# K4's instances: (x dtype, x rows a block, consumer warpgroups), as
# csrc/quant_matmul.cu:launch_rows builds them
K4_INSTANCES = [(t, r, 1 if r <= 64 else 2) for t in ("bf16", "f32")
                for r in (8, 16, 32, 64, 128, 192, 256)]


# ---------------------------------------------------------------------------
# Phase 12: MemVLA-7B trained with its memory bank
# ---------------------------------------------------------------------------

# 12a's micro-batch, and the K1/K3 shapes MemVLA training gives: rows of the
# collator's TRAIN_SEQ_LEN tokens, at 12a's 2 rows (MEMVLA_TRAIN_CASE, held
# by phases 3 and 6) and the recipe's 8 (TRAIN_CASE).  The samples are
# CogACT's template on this suite's own states, so their byte-level answers
# differ in length: 12a's six samples are up to MEMVLA_TRAIN_TOKENS (the
# norm statistics and the rows drawn with the global ``random`` seeded by
# the trainer's seed: the answers' digits follow the statistics).  The
# suite: 8 episodes (one a parallel stream at B=8) of 17 frames (16 actions:
# the action pipeline's trajectory length).
MEMVLA_TRAIN_MICRO, MEMVLA_TRAIN_STEPS, MEMVLA_TRAIN_TOKENS = 2, 2, 1280
MEMVLA_TRAIN_CASE = (MEMVLA_TRAIN_MICRO, TRAIN_SEQ_LEN, 32, 32, 128,
                     TRAIN_SEQ_LEN - MEMVLA_TRAIN_TOKENS, False)
K1_MEMVLA_TRAIN_CHECKED = {(c[0], c[1], c[1]) for c in (MEMVLA_TRAIN_CASE, TRAIN_CASE)}
MEMVLA_SUITE_EPISODES, MEMVLA_SUITE_FRAMES = 8, 17


def memvla_train_exp(dataset: str, out: str, micro: int, steps: int,
                     mode: str = "parallel_stream"):
    """The LIBERO MemVLA twin (playground/benchmarks/libero/libero_memvla.py:
    CogACT-7B widths, DiT-B with memory, a bank of 16, 'parallel_stream',
    remat) with one change, a frozen LLM, on ``dataset``."""
    from dexbotic_tpu_torch.playground.benchmarks.libero.libero_memvla import LiberoMemVLAExp

    exp = LiberoMemVLAExp(device="cuda")
    exp.model = dataclasses.replace(exp.model, dataloader_type=mode)
    exp.data = dataclasses.replace(exp.data, dataset_name=dataset)
    exp.trainer = dataclasses.replace(exp.trainer, output_dir=out, max_steps=steps,
                                      per_device_batch_size=micro, logging_steps=1,
                                      save_steps=steps, resume=False, save_optimizer=False)
    exp.optimizer = dataclasses.replace(exp.optimizer, freeze_llm=True)
    return exp


def redraw_memvla_(model, gen) -> None:
    """The DiT's final layer and its cross-attention out-projections are zero
    at init, the fusion gates ~0 (N(0, 1e-3)): redrawn, so that the loss and
    its gradients see the memory and the bank."""
    redraw_final_(model.action_head, gen)
    with torch.no_grad():
        for blk in model.action_head.blocks:
            blk.xattn.o.weight.normal_(0.0, 0.02, generator=gen)
        for role in model.mem_bank.values():
            role.gate.proj.weight.normal_(0.0, 0.02, generator=gen)


def _memvla_batches(exp, tok, n: int, micro: int) -> tuple[list, int]:
    """The schedule's first ``n`` batches on the card, their draws seeded
    with the trainer's seed (seed_rows_: else the samples, and their
    lengths, follow whatever the phases before drew from the global
    ``random``), and the longest sample's tokens."""
    from dexbotic_tpu_torch.data.collator import Collator

    ds = exp.data.build_data(exp.build_tokenization(tok), exp.action.build_action_process_func())
    seed_rows_(ds, exp.trainer.seed)
    collator = Collator(pad_token_id=tok.pad_token_id, max_length=exp.tokenizer.model_max_length)
    it = exp.schedule_batches(ds, collator, micro)
    host = [next(it) for _ in range(n)]
    n_tok = max(int(b["attention_mask"].sum(1).max()) for b in host)
    return [{k: torch.as_tensor(v).cuda() for k, v in b.items()} for b in host], n_tok


def phase_memvla_train_compare(failures: list, dataset: str) -> dict:
    """Phase 12a: one MemVLA-7B training step (micro-batch 2, the third
    'parallel_stream' batch against the bank the first two filled) at full
    width and depth in fp32, the LLM frozen (it takes no gradient), the
    diffusion draws injected: the kernel path (K1, K3 on q, k, v rounded to
    bf16), the plain path (K1's plain version with autograd on the same
    rounded q, k, v: decoder_plain_on_bf16) and bf16 weights (a copy under
    the Trainer's bf16 rule on the plain attention, a reading), each against an fp32
    witness (the plain attention in fp32): loss, grad_norm and the gradient
    1-cosine of the projector, the DiT and the bank's modules (the SE
    bottleneck, retrieval, gates, timestep embedders).  10a's rule: the
    kernel path's distance <= 2 x the plain path's + 0.25 x the bf16
    copy's (the margin, a reading of the same step).  Then one step in
    'stream' mode (the sequential single bank) on the kernel path."""
    from dexbotic_tpu_torch.exp.optim import global_norm, is_frozen
    from dexbotic_tpu_torch.models.memvla import build_memvla, init_mem_state, memvla_loss
    from dexbotic_tpu_torch.ops.attention import flash_attention, flash_attention_bwd

    import random

    B = MEMVLA_TRAIN_MICRO
    exp = memvla_train_exp(dataset, "out_mem_compare", B, 1)
    random.seed(exp.trainer.seed)  # the statistics redraw episodes' last frames from it
    exp._auto_compute_norm_stats()
    tok = exp.tokenizer.build_tokenizer()
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    cfg, model, _ = exp.build_model(tok)
    redraw_memvla_(model, torch.Generator(device="cuda").manual_seed(120))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"phase 12a: one MemVLA-7B training step ({n_params / 1e9:.3f}B parameters, fp32, "
          f"LLM frozen, micro-batch {B}, parallel_stream): kernel path vs plain path (both on "
          f"bf16 q, k, v) vs fp32 witness; bf16 weights as a reading")
    batches, n_tok = _memvla_batches(exp, tok, 3, B)
    if n_tok != MEMVLA_TRAIN_TOKENS or exp.tokenizer.model_max_length != TRAIN_SEQ_LEN:
        failures.append(f"12a: samples of {n_tok} tokens padded to "
                        f"{exp.tokenizer.model_max_length}: phases 3 and 6 hold K1 and K3 at "
                        f"{MEMVLA_TRAIN_TOKENS} of {TRAIN_SEQ_LEN}")
    plain = plain_config(cfg)
    state = exp.build_aux_state(B)
    with torch.no_grad():  # the bank after the first two batches' frames
        for b in batches[:2]:
            _, _, state = memvla_loss(model, plain, b, state)
    batch = batches[2]
    g = torch.Generator(device="cuda").manual_seed(121)
    rows = cfg.repeated_diffusion_steps * B
    t = torch.randint(0, cfg.diffusion_steps, (rows,), generator=g, device="cuda")
    noise = torch.randn((rows, cfg.chunk_size, cfg.action_dim), generator=g, device="cuda")
    watched = {"projector": ("vlm.projector.",), "dit": ("action_head.",),
               "bank": ("mem_bank.", "per_compr.")}
    trainable = {n for n, _ in model.named_parameters() if not is_frozen(n, exp.optimizer)}

    def run(m, c, sequential=False, b=batch, st=state):
        for n, p in m.named_parameters():
            p.requires_grad_(n in trainable)
        n0 = (flash_attention.launches, flash_attention_bwd.launches)
        with torch.enable_grad():
            loss, _, new = memvla_loss(m, c, b, st, sequential_bank=sequential, remat=True,
                                       diffusion_t=t, diffusion_noise=noise)
            loss.backward()
        named = [(n, p.grad) for n, p in m.named_parameters() if p.grad is not None]
        out = {"loss": float(loss.detach()), "grad_norm": float(global_norm([x for _, x in named])),
               "launches": (flash_attention.launches - n0[0], flash_attention_bwd.launches - n0[1]),
               "counts": new["per"]["count"].tolist()}
        grads = {k: torch.cat([x.float().flatten() for n, x in named if n.startswith(prefixes)])
                 for k, prefixes in watched.items()}
        for p in m.parameters():
            p.grad = None
        m.requires_grad_(False)
        return out, grads

    w32, g32 = run(model, plain)
    with decoder_plain_on_bf16():
        wpl, gpl = run(model, plain)
    wk, gk = run(model, cfg)
    bf, rule = trainer_rule_copy(build_memvla, plain, model, "12a's bf16 copy")
    wbf, gbf = run(bf, plain)
    del bf
    free_memory()
    for label, w in (("kernel", wk), ("plain", wpl), ("bf16", wbf),
                     ("fp32 witness", w32)):
        print(f"  {label}: loss {w['loss']:.6g} grad_norm {w['grad_norm']:.6g}; K1/K3 launches "
              f"{w['launches']}; bank counts after {w['counts']}")
    checks = [(all(math.isfinite(wk[k]) for k in ("loss", "grad_norm")),
               f"12a: non-finite kernel-path metrics {wk}"),
              (wk["launches"][1] >= cfg.vlm.llm.num_layers
               and w32["launches"] == wpl["launches"] == wbf["launches"] == (0, 0),
               f"12a: K1/K3 launches kernel path {wk['launches']}, plain paths "
               f"{wpl['launches']} {w32['launches']} {wbf['launches']}"),
              (wk["counts"] == [3] * B, f"12a: bank counts {wk['counts']} after the third frame")]
    witness, bounds = hold_step("12a", {"kernel": (wk, gk), "plain": (wpl, gpl),
                                        "bf16": (wbf, gbf)}, (w32, g32),
                                {"loss": "rel", "grad_norm": "rel"}, checks)
    # one step in 'stream' mode: two consecutive frames of one episode against one bank
    stream = memvla_train_exp(dataset, "out_mem_stream", B, 1, mode="stream")
    stream._auto_compute_norm_stats()  # the statistics phase 12a computed, from their cache
    sb, _ = _memvla_batches(stream, tok, 1, B)
    ws, gs = run(model, cfg, sequential=True, b=sb[0], st=init_mem_state(cfg, 1, device="cuda"))
    print(f"  stream mode (resets {sb[0]['episode_reset'].tolist()}, frames "
          f"{sb[0]['timesteps'].tolist()}): loss {ws['loss']:.6g} grad_norm {ws['grad_norm']:.6g}; "
          f"K1/K3 launches {ws['launches']}; the shared bank's count after {ws['counts']}")
    checks += [(math.isfinite(ws["loss"]) and math.isfinite(ws["grad_norm"])
                and all(bool(torch.isfinite(x).all()) for x in gs.values()),
                f"12a stream: non-finite {ws}"),
               (ws["counts"] == [B] and ws["launches"][1] >= cfg.vlm.llm.num_layers,
                f"12a stream: bank counts {ws['counts']}, launches {ws['launches']}")]
    failures.extend(msg for ok, msg in checks if not ok)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del model, g32, gpl, gk, gbf, gs, batches, batch, state
    free_memory()
    return {"params": n_params, "prompt_tokens": n_tok, "peak_gib": peak, "kernel": wk,
            "plain": wpl, "bf16": wbf, "fp32_witness": w32, "vs_fp32": witness,
            "bounds": bounds, "stream_step": ws, **rule}


def phase_memvla_train_steps(failures: list, dataset: str) -> dict:
    """Phase 12b: MEMVLA_TRAIN_STEPS steps of MemVLAExp.train() at the
    recipe's micro-batch of 8 ('parallel_stream', the LLM frozen, bf16,
    remat), the bank carried by the Trainer: after each step the bank's
    count of each row (one more, or 1 where the schedule started an
    episode), the step's peak; K1/K3 launches and shapes, K2/K4 launches and
    plain CUDA attention calls read around the run."""
    steps, micro = MEMVLA_TRAIN_STEPS, TRAIN_CASE[0]
    print(f"phase 12b: {steps} MemVLA-7B training steps through MemVLAExp.train() "
          f"(micro-batch {micro}, parallel_stream, LLM frozen)")
    exp = memvla_train_exp(dataset, "out_mem_train", micro, steps)
    cfg = exp.model.build_config()

    def before(trainer, batch):
        return {"resets": np.asarray(batch["episode_reset"]).tolist(),
                "before": trainer.aux_state["per"]["count"].tolist()}

    def after(trainer, batch, row):
        row["after"] = trainer.aux_state["per"]["count"].tolist()

    run = recorded_train(exp, "out_mem_train", before, after)
    log, seen, rows, launches, wall = (run[k] for k in ("log", "seen", "rows", "launches", "wall"))
    shapes, bwd_shapes = run["k1_shapes"], run["k3_shapes"]
    for r, s_ in zip(rows, seen):
        print(f"  step {r['step']}: loss {r['loss']:.6g} grad_norm {r['grad_norm']:.6g} step time "
              f"{1 / r['steps_per_sec']:.4f} s; resets {s_['resets']}; bank counts "
              f"{s_['before']} -> {s_['after']}; peak {s_['peak_gib']:.2f} GiB")
    step_s = statistics.median(1 / r["steps_per_sec"] for r in rows[1:])
    peak = max(s_["peak_gib"] for s_ in seen) if seen else float("nan")
    print(f"  train() wall {wall:.1f} s; step {step_s:.4f} s (median of steps 2-{steps}), "
          f"{micro / step_s:.3f} samples/s; peak {peak:.2f} GiB; launches {launches}; K1 shapes "
          f"{sorted(shapes)}, K3 shapes {sorted(bwd_shapes)}")
    want = [[1 if r else min(b + 1, cfg.mem_length) for r, b in zip(s_["resets"], s_["before"])]
            for s_ in seen]
    unchecked = sorted((shapes | bwd_shapes) - K1_MEMVLA_TRAIN_CHECKED)
    L = cfg.vlm.llm.num_layers
    checks = [(log.get("step") == steps and len(rows) == steps == len(seen),
               f"12b: ran {len(rows)} of {steps} steps"),
              (all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in rows),
               "12b: non-finite loss or grad_norm"),
              ([s_["after"] for s_ in seen] == want and all(seen[0]["resets"]),
               f"12b: bank counts {[s_['after'] for s_ in seen]}, want {want}"),
              (launches["flash_bwd"] >= L * steps and launches["flash_fwd"] >= L * steps
               and launches["plain_cuda_calls"] == launches["dit_sample"]
               == launches["quant_matmul"] == 0,
               f"12b: launches {launches}, want K1 and K3 >= {L * steps}, no K2, K4 or plain call"),
              (not unchecked, f"12b: K1/K3 took shapes phases 3 and 6 do not hold: {unchecked}")]
    failures.extend(msg for ok, msg in checks if not ok)
    return {"launches": launches, "step_s": step_s, "samples_per_s": micro / step_s,
            "peak_gib": peak, "train_wall_s": wall, "bank_counts": [s_["after"] for s_ in seen],
            "k1_shapes": sorted(shapes), "k3_shapes": sorted(bwd_shapes)}


def phase_memvla_train(failures: list) -> dict:
    """Phase 12 in a temp dir (the suite, norm stats, checkpoints), removed after."""
    with tempfile.TemporaryDirectory() as tmp, working_dir(tmp):
        dataset = write_suite(os.path.join(tmp, "suite"), name="mem",
                              frames=MEMVLA_SUITE_FRAMES, episodes=MEMVLA_SUITE_EPISODES)
        compare = phase_memvla_train_compare(failures, dataset)
        free_memory()
        steps = phase_memvla_train_steps(failures, dataset)
        return {"12a_compare": compare, "12b_train": steps}


# ---------------------------------------------------------------------------
# Phase 13: NaVILA-7B served and trained (packed rows, segment-isolated attention)
# ---------------------------------------------------------------------------

# Serving (13a): the llama_3 prompt of NAVILA_INSTRUCTION over 8 frames of
# 196 tokens is NAVILA_PROMPT_TOKENS; generate's bf16 cache holds it and the
# NAVILA_NEW_TOKENS tokens, and K1 takes the prefill (the prompt against
# every cache column) and each decode step (one query row).  Training
# (13b, 13c): a sample of the synthetic suite is 1792-1931 tokens (8 x 196
# image tokens, the dexbotic template, the prompt and the answer), so
# pack_batch puts two a row of the recipe's 4096; NAVILA_SEGMENTS are two
# such lengths.  13b packs 4 samples into 2 rows, 13c 8 into the example
# recipe's 4.  NAVILA_CASES: (result key, kind, rows); phase 3 holds all
# four, phase 6 the packed ones.
NAVILA_INSTRUCTION = "walk past the sofa and stop at the kitchen door"
NAVILA_PROMPT_TOKENS, NAVILA_NEW_TOKENS = 2195, 32
NAVILA_CACHE = NAVILA_PROMPT_TOKENS + NAVILA_NEW_TOKENS
NAVILA_ROW, NAVILA_SEGMENTS = 4096, (1931, 1850)
NAVILA_COMPARE_ROWS, NAVILA_TRAIN_ROWS, NAVILA_TRAIN_STEPS = 2, 4, 2
NAVILA_DECODE_STEP = 15  # the decode call phase 3 holds: 16 tokens in the cache
NAVILA_CASES = [("navila_prefill", "prefill", 1), ("navila_decode", "decode", 1),
                ("navila_compare", "packed", NAVILA_COMPARE_ROWS),
                ("navila_train", "packed", NAVILA_TRAIN_ROWS)]
K1_NAVILA_SERVE_CHECKED = {(1, NAVILA_PROMPT_TOKENS, NAVILA_CACHE), (1, 1, NAVILA_CACHE)}
K1_NAVILA_TRAIN_CHECKED = {(r, NAVILA_ROW, NAVILA_ROW)
                           for r in (NAVILA_COMPARE_ROWS, NAVILA_TRAIN_ROWS)}


def navila_attn_inputs(kind: str, B: int, gen):
    """(name, q, k, v, (q_grp, kv_grp, kv_valid), segments) of a NaVILA K1/K3
    call (LLaMA-2: 32 heads of 128).  'prefill': the prompt against the
    empty bf16 cache of NAVILA_CACHE columns; 'decode': one query row at
    NAVILA_DECODE_STEP against the prompt and the tokens before it (both
    with the cache's all-zero segment ids, (q_seg, kv_seg)); 'packed': B rows
    of NAVILA_ROW, each two segments (NAVILA_SEGMENTS) whose positions
    restart, groups = positions + 1, the tail padding (segment -1)."""
    dev = torch.device("cuda")
    if kind == "packed":
        S = NAVILA_ROW
        pos = torch.zeros(B, S, dtype=torch.int32, device=dev)
        seg = torch.full((B, S), -1, dtype=torch.int32, device=dev)
        valid = torch.zeros(B, S, dtype=torch.int32, device=dev)
        for r in range(B):
            s = 0
            for j, n in enumerate(NAVILA_SEGMENTS):
                pos[r, s: s + n] = torch.arange(n, device=dev, dtype=torch.int32)
                seg[r, s: s + n] = 2 * r + j
                valid[r, s: s + n] = 1
                s += n
        grp = pos + 1
        q = torch.randn(B, S, 32, 128, generator=gen, device=dev).bfloat16()
        k, v = (torch.randn(B, S, 32, 128, generator=gen, device=dev).bfloat16() for _ in range(2))
        name = (f"NaVILA packed B={B} S={S} (segments {NAVILA_SEGMENTS} a row, "
                f"{S - sum(NAVILA_SEGMENTS)} pads) H=32/32 D=128")
        return name, q, k, v, (grp, grp.clone(), valid), seg
    P, C = NAVILA_PROMPT_TOKENS, NAVILA_CACHE
    filled = P if kind == "prefill" else P + NAVILA_DECODE_STEP + 1
    valid = torch.zeros(B, C, dtype=torch.int32, device=dev)
    valid[:, :filled] = 1
    grp = torch.zeros(B, C, dtype=torch.int32, device=dev)
    grp[:, :filled] = torch.arange(1, filled + 1, dtype=torch.int32, device=dev)
    Sq = P if kind == "prefill" else 1
    q_grp = grp[:, :P].clone() if kind == "prefill" else grp[:, filled - 1: filled].clone()
    q = torch.randn(B, Sq, 32, 128, generator=gen, device=dev).bfloat16()
    k, v = (torch.randn(B, C, 32, 128, generator=gen, device=dev).bfloat16() for _ in range(2))
    zeros = (torch.zeros(B, Sq, dtype=torch.int32, device=dev),
             torch.zeros(B, C, dtype=torch.int32, device=dev))
    name = (f"NaVILA {kind} B={B} Sq={Sq} Skv={C} ({filled} cache columns filled) "
            f"H=32/32 D=128")
    return name, q, k, v, (q_grp, grp, valid), zeros


def dead_tile_share(q_grp, kv_grp, kv_valid, seg) -> float:
    """The share of a call's (64-row q tile, 64-row kv tile) pairs K1 and K3
    skip as dead (``flash_tile_classes``: no query row sees a key of it)."""
    from dexbotic_tpu_torch.ops.attention import DEAD, flash_tile_classes

    classes = flash_tile_classes(q_grp, kv_grp, kv_valid, *seg_pair(seg))
    return (classes == DEAD).float().mean().item()


NAVILA_ANSWERS = ["The next action is move forward 75 cm.", "The next action is turn left 30 degree.",
                  "The next action is turn right 15 degree.", "The next action is stop.",
                  "The next action is move forward 50 cm."]


def write_nav_suite(root: str, name: str = "nav", episodes: int = 4, frames: int = 12) -> str:
    """A synthetic navigation suite (seeded): episodes of 240x320 PNG
    frames, each with the instruction (its length varying with the frame)
    and an answer in parse_nav_action's words; returns its name."""
    from PIL import Image

    from dexbotic_tpu_torch.data.registry import register_dataset

    rng = np.random.default_rng(13)
    os.makedirs(root, exist_ok=True)
    yy, xx = np.mgrid[0:240, 0:320]
    for e in range(episodes):
        lines = []
        for t in range(frames):
            img = np.stack([(xx + 11 * t) % 256, (yy + 50 * e) % 256, (xx * yy) // 97 % 256], -1)
            img = (img + rng.integers(0, 24, img.shape)).clip(0, 255).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(root, f"e{e}f{t}.png"))
            prompt = NAVILA_INSTRUCTION + ", then look around the room" * int(rng.integers(0, 4))
            lines.append(json.dumps({"images_1": {"type": "image", "url": f"e{e}f{t}.png"},
                                     "prompt": prompt,
                                     "answer": NAVILA_ANSWERS[int(rng.integers(0, 5))]}))
        with open(os.path.join(root, f"e{e}.jsonl"), "w") as f:
            f.write("\n".join(lines))
    register_dataset({name: {"data_path_prefix": root, "annotations": root, "frequency": 1}},
                     prefix="smoke", meta_data={})
    return f"smoke_{name}"


def navila_exp(dataset: str = "", out: str = "", rows: int = NAVILA_TRAIN_ROWS, steps: int = 1,
               train: bool = False):
    """The example NaVILA recipe (dexbotic_tpu_torch/playground/example_navila_exp.py:
    LLaMA-2-7B + SigLIP-so400m/384 + mlp_downsample, 8 frames, 4096-token
    packed rows, 4 rows a step) on ``dataset``.  Training takes a frozen LLM
    (the full fine-tune of 7.2B waits on the parallel layer), remat, and the
    dexbotic chat template: the training tokenization (tokenize_dexbotic, as
    in the JAX package) refuses llama_3, which serving keeps."""
    from dexbotic_tpu_torch.exp import base_exp
    from dexbotic_tpu_torch.playground.example_navila_exp import MyNaVILAExp

    exp = MyNaVILAExp(device="cuda")
    exp.data = dataclasses.replace(exp.data, dataset_name=dataset)
    if train:
        exp.tokenizer = base_exp.TokenizerConfig(model_max_length=NAVILA_ROW)
    exp.trainer = dataclasses.replace(exp.trainer, output_dir=out, max_steps=steps,
                                      per_device_batch_size=rows, logging_steps=1,
                                      save_steps=steps, resume=False, save_optimizer=False,
                                      gradient_checkpointing=True)
    exp.optimizer = dataclasses.replace(exp.optimizer, freeze_llm=True)
    return exp


@contextlib.contextmanager
def decode_logits(out: list):
    """Appends the logits of every step of ``models/generate.generate`` to
    ``out`` while inside (a wrapper on its lm_logits)."""
    from dexbotic_tpu_torch.models import generate as gen_mod

    call = gen_mod.lm_logits

    def recorded(*args, **kw):
        logits = call(*args, **kw)
        out.append(logits.float())
        return logits

    gen_mod.lm_logits = recorded
    try:
        yield out
    finally:
        gen_mod.lm_logits = call


def _nav_post(port: int, png: bytes, first: bool, run_model: bool) -> tuple:
    """(the reply as a list, seconds) of one NaVILAServer request."""
    extra = {"episode_first_frame": str(first), "run_model": str(run_model)}
    out, dt = _post(port, NAVILA_INSTRUCTION, [png], extra=extra)
    return out.tolist(), dt


def phase_navila_serve(failures: list) -> dict:
    """Phase 13a: NaVILA-7B (the example recipe: LLaMA-2-7B, SigLIP-so400m/384,
    mlp_downsample, 8 frames; seeded bf16 weights by prepare_inference_params)
    served over HTTP by NaVILAServer built by hand (NaVILAExp has no
    inference()), greedy, NAVILA_NEW_TOKENS new tokens: an episode of 3
    frames with run_model=False (each reply []), then model requests (the
    replies parse_nav_action's ints), then a reset.  K1's launches and
    shapes, K2/K3/K4 and plain CUDA attention calls read around the model
    requests.  Then one request's decode teacher-forced: the plain path runs
    the kernel path's prompt and generated tokens in one forward, each step's
    logits at cosine >= 0.999 to the kernel path's, the kernel path's largest
    logit error from an fp32 witness (the plain path on the weights in fp32)
    <= 2x the plain path's + 1e-3, and every step whose argmax differs a
    near-tie by 10c's rule (the plain path's gap <= 2x its largest logit
    error).  K1's launches in one request's prefill and decode, measured.
    p50/p90 of a request and the device call by part.  Returns
    the model, in fp32 after the witness, for phase 13b."""
    from dexbotic_tpu_torch.exp.navila_exp import NaVILAInferenceSession
    from dexbotic_tpu_torch.exp.serve import NaVILAServer
    from dexbotic_tpu_torch.models.generate import generate
    from dexbotic_tpu_torch.models.vlm import encode_images, vlm_forward
    from dexbotic_tpu_torch.nn.transformer import init_kv_cache
    from dexbotic_tpu_torch.ops.attention import flash_attention
    from script.profile_pi0_torch import trace, wall_ms

    exp = navila_exp()
    t0 = time.perf_counter()
    cfg, model, _ = exp.load_for_inference()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    L = cfg.vlm.llm.num_layers
    print(f"phase 13a: NaVILA-7B ({n_params / 1e9:.3f}B params, bf16, built in "
          f"{time.perf_counter() - t0:.1f} s) served through NaVILAServer: greedy, "
          f"{NAVILA_NEW_TOKENS} new tokens, {cfg.num_video_frames} frames of "
          f"{cfg.vlm.num_image_tokens} tokens")
    tok = exp.tokenizer.build_tokenizer()
    server = NaVILAServer(exp, cfg, model, tok, host="127.0.0.1", port=0,
                          max_new_tokens=NAVILA_NEW_TOKENS)
    n_prompt = len(server.session.prompt_ids(NAVILA_INSTRUCTION, cfg.num_video_frames))
    if n_prompt != NAVILA_PROMPT_TOKENS:
        failures.append(f"13a: the prompt is {n_prompt} tokens; phase 3 holds K1 at "
                        f"{NAVILA_PROMPT_TOKENS}")
    pngs = [_frame_png(130 + i) for i in range(7)]
    observed, served = pngs[:3], pngs[3:]
    httpd = server.serve_background()
    port = httpd.server_address[1]
    try:
        silent = [_nav_post(port, png, i == 0, False)[0] for i, png in enumerate(observed)]
        _nav_post(port, served[0], False, True)  # warm-up
        shapes: set = set()
        _zero_counts()
        replies, lat = [], []
        with k1_calls(shapes):
            for png in served[1:]:
                out, dt = _nav_post(port, png, False, True)
                replies.append(out)
                lat.append(dt * 1e3)
        launches = _launch_counts()
        history = len(server.session.buffer.frames)
        reset_reply, _ = _nav_post(port, pngs[0], True, False)
        after_reset = len(server.session.buffer.frames)
    finally:
        httpd.shutdown()
        httpd.server_close()
    n_req = len(replies)
    per_req = launches["flash_fwd"] / n_req
    want_k1 = L * NAVILA_NEW_TOKENS  # the prefill and the 31 steps fed back
    lat_sorted = sorted(lat)
    print(f"  replies {replies}; run_model=False replies {silent} and {reset_reply} after the "
          f"reset; history {history} frames, {after_reset} after the reset")
    print(f"  K1 {launches['flash_fwd']} launches ({per_req:g} a request), K2 "
          f"{launches['dit_sample']}, K3 {launches['flash_bwd']}, K4 {launches['quant_matmul']}, "
          f"plain attention calls on CUDA {launches['plain_cuda_calls']}; K1 shapes {sorted(shapes)}")

    fleet = phase_navila_fleet(failures, exp, cfg, model, tok)  # 14c, on this bf16 model
    free_memory()

    # the device call by part, in bf16; then one request teacher-forced (hold_decode)
    sess = NaVILAInferenceSession(exp, cfg, model, tok, max_new_tokens=NAVILA_NEW_TOKENS)
    for png in observed:
        sess.observe(server.frame([("f", png)]))
    ids, valid, imgs = sess.inputs(server.frame([("f", served[0])]), NAVILA_INSTRUCTION)
    eos = sess.eos_token_id
    plain = plain_config(cfg)
    with torch.no_grad():
        def prefill():
            cache = init_kv_cache(cfg.vlm.llm, 1, NAVILA_CACHE, device="cuda")
            return vlm_forward(model.vlm, cfg.vlm, ids, valid, images=imgs, cache=cache,
                               update_cache=True)

        def call():
            return generate(model.vlm, cfg.vlm, ids, valid, imgs, NAVILA_NEW_TOKENS, eos)

        n0 = flash_attention.launches
        prefill()
        k1_prefill = flash_attention.launches - n0
        n0 = flash_attention.launches
        call()
        k1_generate = flash_attention.launches - n0

        host = []  # a request's host work: the PNG decoded, 8 frames preprocessed, the prompt
        for _ in range(5):  # tokenized, the inputs uploaded (the frame joins the history)
            t0 = time.perf_counter()
            sess.inputs(server.frame([("f", served[0])]), NAVILA_INSTRUCTION)
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        tower = wall_ms(lambda: encode_images(model.vlm, cfg.vlm, imgs), reps=PART_REPS)
        pre = wall_ms(prefill, reps=PART_REPS)
        whole = wall_ms(call, reps=PART_REPS)
        busy, n_kernels, _ = trace(call)
        decode = whole - pre
        parts = {"tower_projector_ms": tower, "prefill_ms": pre - tower, "decode_ms": decode,
                 "decode_ms_per_token": decode / NAVILA_NEW_TOKENS, "device_call_ms": whole,
                 "host_preprocess_ms": statistics.median(host),
                 "p50_less_device_call_ms": statistics.median(lat_sorted) - whole,
                 "device_busy_ms": busy,
                 "idle_share": 1 - busy / whole, "kernels": n_kernels,
                 "k1_prefill_launches": k1_prefill,
                 "k1_decode_launches": k1_generate - k1_prefill}
    checks: list = []
    witness = hold_decode(  # the weights end in fp32: the witness, and 13b's start
        "13a", model, lambda: model.vlm.llm, cfg.vlm.llm, n_prompt,
        lambda: generate(model.vlm, cfg.vlm, ids, valid, imgs, NAVILA_NEW_TOKENS, eos)[0],
        lambda toks: vlm_forward(model.vlm, plain.vlm, torch.cat([ids, toks[:, :-1]], 1),
                                 torch.ones(1, n_prompt + toks.shape[1] - 1, dtype=torch.int32,
                                            device="cuda"), images=imgs),
        eos, checks)
    near_tie = witness["near_tie_bound"]
    row = {"p50_ms": statistics.median(lat_sorted), "p90_ms": float(np.percentile(lat_sorted, 90)),
           "requests": n_req, "k1_per_request": per_req, "launches": launches,
           "prompt_tokens": n_prompt, "params": n_params, "k1_shapes": sorted(shapes),
           "replies": replies, **witness, **parts}
    print(f"  {n_req} requests p50 {row['p50_ms']:.1f} ms, p90 {row['p90_ms']:.1f} ms; device call "
          f"{whole:.1f} ms = tower {tower:.1f} + prefill {pre - tower:.1f} + {NAVILA_NEW_TOKENS} "
          f"decode steps {decode:.1f} ({decode / NAVILA_NEW_TOKENS:.2f} a token); K1 launches "
          f"prefill {k1_prefill}, decode {k1_generate - k1_prefill}; host "
          f"preprocessing {parts['host_preprocess_ms']:.1f} ms a request (p50 less the device "
          f"call {parts['p50_less_device_call_ms']:.1f}); device idle {parts['idle_share']:.1%} "
          f"of the call over {n_kernels} kernels")
    unchecked = sorted(shapes - K1_NAVILA_SERVE_CHECKED)
    checks += [(silent == [[]] * len(observed) and reset_reply == [] and after_reset == 1
               and history == len(observed) + len(served), f"13a: run_model=False replies "
               f"{silent} / {reset_reply}, history {history}, {after_reset} after the reset"),
              (all(isinstance(r, list) and r and all(a in (0, 1, 2, 3) for a in r)
                   for r in replies), f"13a: replies {replies}"),
              (launches["flash_fwd"] == n_req * want_k1 and launches["flash_bwd"]
               == launches["dit_sample"] == launches["quant_matmul"]
               == launches["plain_cuda_calls"] == 0,
               f"13a: launches {launches}, want K1 {n_req} x {want_k1} and nothing else"),
              (not unchecked and shapes, f"13a: K1 took shapes phase 3 does not hold: {unchecked}"),
              (k1_prefill == L and k1_generate - k1_prefill == L * (NAVILA_NEW_TOKENS - 1),
               f"13a: K1 launches prefill {k1_prefill}, decode {k1_generate - k1_prefill}, want "
               f"{L} and {L} x {NAVILA_NEW_TOKENS - 1}")]
    failures.extend(msg for ok, msg in checks if not ok)
    fleet["vs_generate"] = fleet.pop("hold")(near_tie)  # 14c by the bound 13a's witness gives
    fleet["decode_ms_a_token_single_stream"] = parts["decode_ms_per_token"]
    print(f"  14c: decode {fleet['ms_a_token_full']} ms a token with {NAVILA_FLEET_SLOTS} live "
          f"slots, {parts['decode_ms_per_token']:.2f} ms a token for 13a's single stream")
    del server, sess
    return {**row, "14c_fleet": fleet, "model": model, "cfg": cfg, "tokenizer": tok}


def phase_navila_train_compare(failures: list, dataset: str, model, cfg) -> dict:
    """Phase 13b: one packed NaVILA-7B training step (4 samples in 2 rows of
    4096, the soft CE over the digit ids) on 13a's weights in fp32, the LLM
    frozen: kernel path, plain path (K1's plain version with autograd on the
    same bf16-rounded q, k, v) and bf16 weights (cast in place by the
    Trainer's bf16 rule: the fp32 values are bf16 values), each against the fp32
    witness: loss, grad_norm and the gradient 1-cosine of the projector,
    the tower and lm_head, held by 12a's rule.  The packed loss (kernel
    path) against navila_loss on the same 4 samples unpacked, a forward:
    within 2 x the kernel-vs-plain loss distance + 1e-3, relative."""
    from dexbotic_tpu_torch.data.collator import Collator
    from dexbotic_tpu_torch.exp.optim import global_norm, is_frozen
    from dexbotic_tpu_torch.models.navila import navila_loss, navila_packed_loss
    from dexbotic_tpu_torch.nn.core import cast_like_jax_
    from dexbotic_tpu_torch.ops.attention import flash_attention, flash_attention_bwd

    R = NAVILA_COMPARE_ROWS
    exp = navila_exp(dataset, "out_nav_compare", rows=R, train=True)
    tok = exp.tokenizer.build_tokenizer()
    ds = exp.data.build_data(exp.build_tokenization(tok))
    collator = Collator(pad_token_id=tok.pad_token_id, max_length=exp.tokenizer.model_max_length)
    lens = sorted(len(ds[i]["input_ids"]) for i in range(0, len(ds), 5))
    it = exp.packed_batches(ds, collator, tok.pad_token_id, R)
    host = next(it)
    batch = {k: torch.as_tensor(v).cuda() for k, v in host.items()}
    segs = [len(set(r[r >= 0].tolist())) for r in host["segments"]]
    print(f"phase 13b: one packed NaVILA-7B training step ({len(host['images'])} samples in {R} "
          f"rows of {host['input_ids'].shape[1]}: {segs} segments a row; samples of "
          f"{lens[0]}-{lens[-1]} tokens), fp32 weights, LLM frozen: kernel path vs plain path vs "
          f"fp32 witness; bf16 weights as a reading")
    soft = exp._digit_ids(tok)
    watched = {"projector": ("vlm.projector.",), "vit": ("vlm.vit.",),
               "lm_head": ("vlm.llm.lm_head.",)}
    trainable = {n for n, _ in model.named_parameters() if not is_frozen(n, exp.optimizer)}
    plain = plain_config(cfg)

    def run(c):
        for n, p in model.named_parameters():
            p.requires_grad_(n in trainable)
        n0 = (flash_attention.launches, flash_attention_bwd.launches)
        with torch.enable_grad():
            loss, _ = navila_packed_loss(model, c, batch, soft, remat=True)
            loss.backward()
        named = [(n, p.grad) for n, p in model.named_parameters() if p.grad is not None]
        out = {"loss": float(loss.detach()), "grad_norm": float(global_norm([x for _, x in named])),
               "launches": (flash_attention.launches - n0[0], flash_attention_bwd.launches - n0[1])}
        grads = {k: torch.cat([x.float().flatten() for n, x in named if n.startswith(prefixes)])
                 for k, prefixes in watched.items()}
        for p in model.parameters():
            p.grad = None
        model.requires_grad_(False)
        free_memory()
        return out, grads

    torch.cuda.reset_peak_memory_stats()
    w32, g32 = run(plain)
    with decoder_plain_on_bf16():
        wpl, gpl = run(plain)
    wk, gk = run(cfg)
    unpacked = collator([ds[i] for i in first_pack_indices(exp, ds)])
    with torch.no_grad():
        ub = {k: torch.as_tensor(v).cuda() for k, v in unpacked.items()
              if k in ("input_ids", "labels", "attention_mask", "images")}
        lu = float(navila_loss(model, cfg, ub, soft)[0])
    del ub
    cast_like_jax_(model, torch.bfloat16)
    rule = print_bf16_rule("13b's bf16 weights", model)
    wbf, gbf = run(plain)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for label, w in (("kernel", wk), ("plain", wpl), ("bf16", wbf),
                     ("fp32 witness", w32)):
        print(f"  {label}: loss {w['loss']:.6g} grad_norm {w['grad_norm']:.6g}; K1/K3 launches "
              f"{w['launches']}")
    L = cfg.vlm.llm.num_layers
    checks = [(all(math.isfinite(wk[k]) for k in ("loss", "grad_norm")),
               f"13b: non-finite kernel-path metrics {wk}"),
              (min(segs) >= 2, f"13b: rows of {segs} segments; the suite must pack 2 or more"),
              (wk["launches"][1] >= L
               and w32["launches"] == wpl["launches"] == wbf["launches"] == (0, 0),
               f"13b: K1/K3 launches kernel path {wk['launches']}, plain paths "
               f"{wpl['launches']} {w32['launches']} {wbf['launches']}")]
    witness, bounds = hold_step("13b", {"kernel": (wk, gk), "plain": (wpl, gpl),
                                        "bf16": (wbf, gbf)}, (w32, g32),
                                {"loss": "rel", "grad_norm": "rel"}, checks)
    kp_rel = abs(wk["loss"] - wpl["loss"]) / abs(wpl["loss"])
    pu_rel = abs(wk["loss"] - lu) / abs(lu)
    pu_bound = 2.0 * kp_rel + 1e-3
    print(f"  packed loss {wk['loss']:.6g} vs navila_loss on the same samples unpacked {lu:.6g}: "
          f"rel {pu_rel:.3g} (bound {pu_bound:.3g}); peak {peak:.2f} GiB")
    checks.append((pu_rel <= pu_bound, f"13b: packed vs unpacked loss rel {pu_rel} > {pu_bound}"))
    failures.extend(msg for ok, msg in checks if not ok)
    return {"rows": R, "samples": len(host["images"]), "segments": segs, "sample_tokens": lens,
            "peak_gib": peak, "kernel": wk, "plain": wpl, "bf16": wbf,
            "fp32_witness": w32, "vs_fp32": witness, "bounds": bounds, "unpacked_loss": lu,
            "packed_vs_unpacked_rel": pu_rel, **rule}


def first_pack_indices(exp, ds) -> list:
    """The sample indices of the first packed step of ``exp.packed_batches``."""
    from dexbotic_tpu_torch.exp.mem_trainer import length_grouped_batches

    R = exp.trainer.per_device_batch_size
    K = exp.model.samples_per_pack or 2 * R
    return next(b for b in length_grouped_batches(ds.length_hints(), K, seed=exp.trainer.seed)
                if len(b) == K)


def phase_navila_train_steps(failures: list, dataset: str) -> dict:
    """Phase 13c: NAVILA_TRAIN_STEPS packed steps of NaVILAExp.train() at full
    depth (the example recipe's 4 rows of 4096, 8 samples a step, remat, the
    LLM frozen, bf16): each step's non-pad tokens, pack fill, segments and
    dead-tile share (flash_tile_classes of its masks) and peak; K1/K3
    launches and shapes, K2/K4 and plain CUDA attention calls around it."""
    steps, R = NAVILA_TRAIN_STEPS, NAVILA_TRAIN_ROWS
    print(f"phase 13c: {steps} packed NaVILA-7B training steps through NaVILAExp.train() "
          f"({R} rows of {NAVILA_ROW}, LLM frozen, remat)")
    exp = navila_exp(dataset, "out_nav_train", rows=R, steps=steps, train=True)
    L = exp.model.build_config().vlm.llm.num_layers

    def after(trainer, batch, row):  # the step's masks, read after it
        valid = torch.as_tensor(batch["attention_mask"]).cuda().int()
        pos = torch.as_tensor(batch["positions"]).cuda().int()
        seg = torch.as_tensor(batch["segments"]).cuda().int()
        row.update(tokens=int(valid.sum()), fill=valid.float().mean().item(),
                   segments=[len(set(r[r >= 0].tolist())) for r in batch["segments"]],
                   dead_tile_share=dead_tile_share(pos + 1, pos + 1, valid, seg))

    run = recorded_train(exp, "out_nav_train", after=after)
    log, seen, rows, launches, wall = (run[k] for k in ("log", "seen", "rows", "launches", "wall"))
    shapes, bwd_shapes = run["k1_shapes"], run["k3_shapes"]
    for r, s_ in zip(rows, seen):
        print(f"  step {r['step']}: loss {r['loss']:.6g} grad_norm {r['grad_norm']:.6g} step time "
              f"{1 / r['steps_per_sec']:.4f} s; {s_['tokens']} tokens (fill {s_['fill']:.1%}), "
              f"segments {s_['segments']}, dead tiles {s_['dead_tile_share']:.1%}; peak "
              f"{s_['peak_gib']:.2f} GiB")
    step_s = statistics.median(1 / r["steps_per_sec"] for r in rows[1:])
    tokens = statistics.median(s_["tokens"] for s_ in seen[1:])
    peak = max(s_["peak_gib"] for s_ in seen) if seen else float("nan")
    print(f"  train() wall {wall:.1f} s; step {step_s:.4f} s (median of steps 2-{steps}), "
          f"{tokens / step_s:.1f} tokens/s; peak {peak:.2f} GiB; launches {launches}; K1 shapes "
          f"{sorted(shapes)}, K3 shapes {sorted(bwd_shapes)}")
    unchecked = sorted((shapes | bwd_shapes) - K1_NAVILA_TRAIN_CHECKED)
    checks = [(log.get("step") == steps and len(rows) == steps == len(seen),
               f"13c: ran {len(rows)} of {steps} steps"),
              (all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in rows),
               "13c: non-finite loss or grad_norm"),
              (all(min(s_["segments"]) >= 2 for s_ in seen), "13c: a row of one segment"),
              (launches["flash_fwd"] > 0 and launches["flash_bwd"] >= L * steps
               and launches["plain_cuda_calls"] == launches["dit_sample"]
               == launches["quant_matmul"] == 0,
               f"13c: launches {launches}, want K1 > 0, K3 >= {L * steps}, no K2, K4 or plain "
               f"call"),
              (not unchecked, f"13c: K1/K3 took shapes phases 3 and 6 do not hold: {unchecked}")]
    failures.extend(msg for ok, msg in checks if not ok)
    return {"launches": launches, "step_s": step_s, "tokens_per_s": tokens / step_s,
            "tokens_per_step": tokens, "fill": statistics.median(s_["fill"] for s_ in seen),
            "dead_tile_share": statistics.median(s_["dead_tile_share"] for s_ in seen),
            "peak_gib": peak, "train_wall_s": wall, "rows": R, "k1_shapes": sorted(shapes),
            "k3_shapes": sorted(bwd_shapes)}


def phase_navila(failures: list) -> dict:
    """Phase 13: serving (13a) builds the bf16 model, whose weights 13b
    trains in fp32 and 13e (bf16 weights after 13b) runs through the
    context-parallel loss; 13f times the ring's hops; 13c runs the exp's own
    train().  In a temp dir (the suite, checkpoints), removed after."""
    serve = phase_navila_serve(failures)
    model, cfg = serve.pop("model"), serve.pop("cfg")
    serve.pop("tokenizer")
    free_memory()
    with tempfile.TemporaryDirectory() as tmp, working_dir(tmp):
        dataset = write_nav_suite(os.path.join(tmp, "nav"))
        compare = phase_navila_train_compare(failures, dataset, model, cfg)
        cp = phase_navila_cp(failures, dataset, model, cfg)
        del model
        free_memory()
        hops = phase_ring_hops(failures)
        steps = phase_navila_train_steps(failures, dataset)
    return {"13a_serve": serve, "13b_compare": compare, "13e_cp": cp, "13f_ring_hops": hops,
            "13c_train": steps}


# ---------------------------------------------------------------------------
# Phase 14: the continuous-batching decode engine (exp/decode_engine.py):
# Discrete VLA-7B served (14a) and trained (14b), a NaVILA fleet on one
# shared engine (14c, run inside phase 13 on 13a's model), MUVLA-7B served
# and trained (14d)
# ---------------------------------------------------------------------------

# Discrete VLA-7B (DiscreteVLAModelConfig's defaults: LLaMA-2-7B + CLIP-L/336
# + mlp2x_gelu).  The LIBERO instruction in the CogACT prompt with an empty
# assistant turn is DISCRETE_PROMPT_TOKENS ids (576 image slots) in the
# 64-token bucket DISCRETE_BUCKET; the server's engine holds max_prompt =
# DISCRETE_MAX_PROMPT (serve.engine_max_prompt: the bucket of the prompt
# around an empty text + 64) + DISCRETE_NEW columns.  K1 there: a prefill of
# b admitted prompts (b x 896, b = 1..8), with prefill_chunk=512 two chunks
# at B=8 (512 and 384 rows against the cache's 928 columns, the other slots
# parked), one query row a slot against the 928 columns, and generate's
# prefill and decode (1 x 855 and 1 x 1 against 887: the route without the
# engine, the sampled retries and the references).  Training rows: the
# suite's samples of up to DISCRETE_TRAIN_TOKENS, padded by the collator to
# TRAIN_SEQ_LEN.  Random weights rarely print seven integers:
# DISCRETE_RETRIES (max_retries) is 1, not 40, as the JAX package's own test.
DISCRETE_PROMPT_TOKENS, DISCRETE_BUCKET, DISCRETE_MAX_PROMPT, DISCRETE_NEW = 855, 896, 896, 32
DISCRETE_CACHE = DISCRETE_MAX_PROMPT + DISCRETE_NEW
DISCRETE_SLOTS, DISCRETE_CHUNK, DISCRETE_CLIENTS, DISCRETE_CLIENT_REQUESTS = 8, 512, 8, 1
DISCRETE_RETRIES, DISCRETE_TRAIN_TOKENS, DISCRETE_TRAIN_MICRO, DISCRETE_TRAIN_STEPS = 1, 884, 8, 2
# 14a serves DISCRETE_SERVE_LAYERS of LLaMA-2-7B's 32 decoder layers (every
# width kept): the decode is host-bound at ~55 eager kernels a layer and a
# token, and a request whose text does not parse (every one with random
# weights) runs two more generate calls one at a time, so 14a's time grows
# with the depth (PERF.md §6).  14b's steps train all 32.
DISCRETE_SERVE_LAYERS = 4
# MUVLA-7B (MUVLAModelConfig's defaults through the example recipe, whose
# processor is clip_336): a map view and MUVLA_VIEWS observation views give
# 576 + 192 fused slots; each client's instruction (MUVLA_INSTRUCTIONS, one
# length) makes a MUVLA_PROMPT_TOKENS prompt in the MUVLA_BUCKET bucket; the
# engine (4 slots) holds MUVLA_MAX_PROMPT + MUVLA_NEW columns.  14d's training
# rows: the prompt + an answer of 38 or 39 byte-level tokens + EOS, padded to
# MUVLA_TRAIN_TOKENS.
MUVLA_INSTRUCTIONS = ("go to the red door", "go to the tan door", "go to the big door",
                      "go to the old door")
MUVLA_VIEWS, MUVLA_PROMPT_TOKENS, MUVLA_BUCKET, MUVLA_MAX_PROMPT, MUVLA_NEW = 4, 959, 960, 1024, 32
MUVLA_SLOTS, MUVLA_CLIENT_REQUESTS, MUVLA_TRAIN_TOKENS = 4, 1, 999
MUVLA_SEQUENTIAL = 2  # 14d's requests without the engine, after a warm-up
MUVLA_ANSWERS = ("The next action is move forward 75 cm.",
                 "The next action is turn left 30 degree.")
# 14c: four NaVILA sessions on make_shared_engine(slots=4, max_prompt=2240,
# prefill_chunk=512), its default 48 columns of decode; 13a's 2195-token
# prompt is admitted in chunks of 4 x 512 four times and 4 x 192 against the
# 2288 columns; each session asks NAVILA_FLEET_REQUESTS times.
NAVILA_FLEET_SLOTS, NAVILA_FLEET_MAX_PROMPT, NAVILA_FLEET_CHUNK = 4, 2240, 512
NAVILA_FLEET_NEW, NAVILA_FLEET_REQUESTS = 48, 1
NAVILA_FLEET_CACHE = NAVILA_FLEET_MAX_PROMPT + NAVILA_FLEET_NEW


def _engine_cases() -> list:
    """Phases 3's engine cases: (result key or None, kind, B, keywords of
    engine_attn_inputs).  Keyed ones also take SDPA's time."""
    d = dict(prompt=DISCRETE_PROMPT_TOKENS, P=DISCRETE_MAX_PROMPT, N=DISCRETE_NEW)
    m = dict(prompt=MUVLA_PROMPT_TOKENS, P=MUVLA_MAX_PROMPT, N=MUVLA_NEW)
    n = dict(prompt=NAVILA_PROMPT_TOKENS, P=NAVILA_FLEET_MAX_PROMPT, N=NAVILA_FLEET_NEW)
    cases = [("discrete_generate_prefill", "generate", 1, dict(d, step=-1)),
             ("discrete_generate_decode", "generate", 1, dict(d, step=DISCRETE_NEW // 2)),
             ("discrete_decode", "decode", DISCRETE_SLOTS, d),
             ("discrete_chunk", "chunk", DISCRETE_SLOTS, dict(d, off=0, chunk=DISCRETE_CHUNK)),
             ("discrete_chunk_tail", "chunk", DISCRETE_SLOTS,
              dict(d, off=DISCRETE_CHUNK, chunk=DISCRETE_BUCKET - DISCRETE_CHUNK))]
    cases += [("discrete_admit" if b == DISCRETE_SLOTS else None, "padded", b,
               dict(prompt=DISCRETE_PROMPT_TOKENS, bucket=DISCRETE_BUCKET))
              for b in range(1, DISCRETE_SLOTS + 1)]
    cases += [("navila_fleet_chunk", "chunk", NAVILA_FLEET_SLOTS,
               dict(n, off=0, chunk=NAVILA_FLEET_CHUNK)),
              (None, "chunk", NAVILA_FLEET_SLOTS,
               dict(n, off=4 * NAVILA_FLEET_CHUNK,
                    chunk=NAVILA_FLEET_MAX_PROMPT - 4 * NAVILA_FLEET_CHUNK)),
              ("navila_fleet_decode", "decode", NAVILA_FLEET_SLOTS, n),
              ("muvla_generate_prefill", "generate", 1, dict(m, step=-1)),
              (None, "generate", 1, dict(m, step=MUVLA_NEW // 2)),
              ("muvla_decode", "decode", MUVLA_SLOTS, m)]
    cases += [("muvla_admit" if b == MUVLA_SLOTS else None, "padded", b,
               dict(prompt=MUVLA_PROMPT_TOKENS, bucket=MUVLA_BUCKET))
              for b in range(1, MUVLA_SLOTS + 1)]
    return cases


def engine_shape(kind: str, B: int, prompt: int, P: int = 0, N: int = 0, off: int = 0,
                 chunk: int = 0, bucket: int = 0, step: int = 0) -> tuple:
    """(B, query rows, key rows) of an engine case."""
    if kind == "padded":
        return B, bucket, bucket
    if kind == "generate":
        return B, prompt if step < 0 else 1, prompt + N
    return B, chunk if kind == "chunk" else 1, P + N


K1_DISCRETE_CHECKED = {engine_shape(kind, B, **kw) for key, kind, B, kw in _engine_cases()
                       if kw.get("P") == DISCRETE_MAX_PROMPT or kw.get("bucket") == DISCRETE_BUCKET}
K1_MUVLA_CHECKED = {engine_shape(kind, B, **kw) for key, kind, B, kw in _engine_cases()
                    if kw.get("P") == MUVLA_MAX_PROMPT or kw.get("bucket") == MUVLA_BUCKET}
K1_NAVILA_FLEET_CHECKED = {engine_shape(kind, B, **kw) for key, kind, B, kw in _engine_cases()
                           if kw.get("P") == NAVILA_FLEET_MAX_PROMPT}
DISCRETE_TRAIN_CASE = (DISCRETE_TRAIN_MICRO, TRAIN_SEQ_LEN, 32, 32, 128,
                       TRAIN_SEQ_LEN - DISCRETE_TRAIN_TOKENS, False)
MUVLA_TRAIN_CASE = (2, MUVLA_TRAIN_TOKENS, 32, 32, 128, 1, False)
K1_DISCRETE_TRAIN_CHECKED = {(b, TRAIN_SEQ_LEN, TRAIN_SEQ_LEN) for b in (2, DISCRETE_TRAIN_MICRO)}


def engine_attn_inputs(kind: str, B: int, gen, prompt: int, P: int = 0, N: int = 0,
                       off: int = 0, chunk: int = 0, bucket: int = 0, step: int = 0):
    """(name, q, k, v, (q_grp, kv_grp, kv_valid), (q_seg, kv_seg)) of a K1
    call of the decode engine or of generate (LLaMA-2: 32 heads of 128), with
    the caches' all-zero segment ids.

    'padded': an admission's prefill of B prompts of ``prompt`` tokens in
    their ``bucket``, pads trailing.  'generate': generate's prefill
    (``step`` < 0) or the decode step ``step`` against its cache of
    prompt + N columns.  'decode': one query row a slot against the engine's
    P + N columns: slot b holds a prompt of prompt - 3b tokens in columns
    [0, L) and (7b + 1) mod N decode tokens from column P on, the last of
    them the query; the slots of range(2, B, 3) are empty (no valid column:
    their rows see no key).  'chunk': columns [off, off + chunk) of the
    prompt of the admitted slots (0, 1 and, at B > 4, 4), whose earlier
    chunks fill [0, off); the other slots are parked (their queries see
    their own prompt and decode columns), the last one (and slot 5 at
    B > 5) empty."""
    dev = torch.device("cuda")
    z = dict(dtype=torch.int32, device=dev)
    if kind == "padded":
        valid = torch.zeros(B, bucket, **z)
        valid[:, :prompt] = 1
        grp = torch.cumsum(valid, 1, dtype=torch.int32)
        q_grp, Sq, Skv = grp.clone(), bucket, bucket
        name = f"engine admission B={B} S={bucket} ({bucket - prompt} pads trailing)"
    elif kind == "generate":
        Skv = prompt + N
        filled = prompt if step < 0 else prompt + step + 1
        valid = torch.zeros(B, Skv, **z)
        valid[:, :filled] = 1
        grp = torch.zeros(B, Skv, **z)
        grp[:, :filled] = torch.arange(1, filled + 1, **z)
        Sq = prompt if step < 0 else 1
        q_grp = grp[:, filled - Sq: filled].clone()
        name = f"generate {'prefill' if step < 0 else 'decode'} B={B} Sq={Sq} Skv={Skv}"
    else:
        Skv = P + N
        valid, grp = torch.zeros(B, Skv, **z), torch.zeros(B, Skv, **z)
        Sq = 1 if kind == "decode" else chunk
        q_grp = torch.zeros(B, Sq, **z)
        if kind == "decode":
            empty, admitted = set(range(2, B, 3)), set()
        else:
            empty = {B - 1} | ({5} if B > 5 else set())
            admitted = {0, 1} | ({4} if B > 4 else set())
        for b in range(B):
            if b in empty:
                continue
            if b in admitted:
                n = min(off + chunk, prompt)
                valid[b, :n] = 1
                grp[b, :n] = torch.arange(1, n + 1, **z)
                q_grp[b] = torch.clamp(torch.arange(off + 1, off + chunk + 1, **z), max=prompt)
                continue
            L, nd = prompt - 3 * b, (7 * b + 1) % N if kind == "decode" else (5 * b) % N
            if kind == "decode":
                nd = max(nd, 1)  # the query's own token is written before it attends
            valid[b, :L] = 1
            grp[b, :L] = torch.arange(1, L + 1, **z)
            valid[b, P: P + nd] = 1
            grp[b, P: P + nd] = torch.arange(L + 1, L + nd + 1, **z)
            q_grp[b] = L + nd
        name = (f"engine {'decode' if kind == 'decode' else f'chunk at {off}'} B={B} Sq={Sq} "
                f"Skv={Skv} (empty slots {sorted(empty)}"
                f"{'' if kind == 'decode' else f', admitted {sorted(admitted)}'})")
    q = torch.randn(B, Sq, 32, 128, generator=gen, device=dev).bfloat16()
    k, v = (torch.randn(B, Skv, 32, 128, generator=gen, device=dev).bfloat16() for _ in range(2))
    segs = (torch.zeros(B, Sq, **z), torch.zeros(B, Skv, **z))
    return name + " H=32/32 D=128", q, k, v, (q_grp, grp, valid), segs


class EngineProbe:
    """Records an engine's ticks (live slots, the step's wall ms, CUDA
    synchronised) and each request's returned tokens, keyed by ``key(ids,
    images, embeds)``: wrappers on the instance's ``_step_fn`` and
    ``submit``, no change to the engine."""

    def __init__(self, engine, key):
        self.engine, self.ticks, self.tokens = engine, [], {}
        step, submit = engine._step_fn, engine.submit

        def timed(*args):
            live = int(engine.live.sum())
            t0 = time.perf_counter()
            out = step(*args)
            if engine.device.type == "cuda":
                torch.cuda.synchronize()
            self.ticks.append((live, (time.perf_counter() - t0) * 1e3))
            return out

        def recorded(ids, images=None, embeds=None, **kw):
            toks = submit(ids, images=images, embeds=embeds, **kw)
            self.tokens.setdefault(key(ids, images, embeds), []).append(list(toks))
            return toks

        engine._step_fn, engine.submit = timed, recorded

    def summary(self) -> dict:
        """Mean live slots a tick, median ms a tick and a token at full
        slots, and the largest gap between consecutive ticks around an
        admission (``tick_times`` and ``admit_log``), split by chunking."""
        eng = self.engine
        full = [ms for live, ms in self.ticks if live == eng.S]
        gaps = {True: 0.0, False: 0.0}
        ticks = eng.tick_times
        for t0, t1, _, _, chunked in eng.admit_log:
            for a, b in zip(ticks, ticks[1:]):
                if a < t1 and b > t0:  # the interval between two ticks overlaps the admission
                    gaps[chunked] = max(gaps[chunked], (b - a) * 1e3)
        return {"ticks": len(self.ticks), "batched_steps": eng.batched_steps,
                "mean_live_slots": statistics.mean(l for l, _ in self.ticks) if self.ticks else 0.0,
                "ms_a_tick_full": statistics.median(full) if full else None,
                "ms_a_token_full": statistics.median(full) / eng.k if full else None,
                "admissions": len(eng.admit_log),
                "max_tick_gap_admission_ms": gaps[False] or None,
                "max_tick_gap_chunked_admission_ms": gaps[True] or None}


def hold_decode(label: str, model, llm_mod, llm_cfg, n_prompt: int, generate_call,
                forward_full, eos: int, checks: list) -> dict:
    """13a's rule on one request: its greedy decode through the kernel path
    (``generate_call`` -> tokens [1, n], each step's logits recorded), the
    same tokens teacher-forced through the plain path in one forward
    (``forward_full(tokens)`` -> hidden), then ``model.float()`` and the same
    through the plain path as the fp32 witness: logit cosine >= 0.999 a
    step, the kernel path's largest logit error <= 2x the plain path's +
    1e-3, and an argmax that differs from the plain path's only across a
    near-tie (the plain path's top-two gap <= 2x its largest error).
    Leaves ``model`` in fp32; returns the readings, the near-tie bound and
    the decode's tokens and logits."""
    from dexbotic_tpu_torch.nn.transformer import lm_logits

    logits_k: list = []
    with torch.no_grad(), decode_logits(logits_k):
        toks = generate_call()
    lk_all = torch.cat(logits_k)
    n_steps = toks.shape[1]
    hit = (toks[0] == eos).nonzero()
    if len(hit):
        n_steps = int(hit[0, 0]) + 1

    def teacher_forced():
        hidden = forward_full(toks)
        return lm_logits(llm_mod(), llm_cfg,
                         hidden[0, n_prompt - 1: n_prompt - 1 + n_steps]).float()

    with torch.no_grad():
        lp = teacher_forced()
        lk = lk_all[:n_steps]
        cos = [_cosine(a.double(), b.double()) for a, b in zip(lk, lp)]
        model.float()
        lw = teacher_forced()
    held = hold_logits(label, f"teacher-forced over {n_steps} steps", "steps", lk, lp, lw, checks)
    checks.append((min(cos) >= 0.999, f"{label}: teacher-forced logit cosine {min(cos)} < 0.999"))
    return {"teacher_forced_steps": n_steps, "logit_cosine_min": min(cos), **held}


def hold_logits(label: str, what: str, rows: str, lk, lp, lw, checks: list) -> dict:
    """10c's rule on logits [n, V] of the kernel path ``lk`` and the plain
    path ``lp`` against an fp32 witness ``lw``: the kernel path's largest
    error <= 2x the plain path's + 1e-3, and an argmax that differs from the
    plain path's only across a near-tie (the plain path's top-two gap <= 2x
    its largest error)."""
    err_p, err_k = (lp - lw).abs().max().item(), (lk - lw).abs().max().item()
    ak, ap = lk.argmax(-1), lp.argmax(-1)
    flips = ak != ap
    gaps = (lp.gather(-1, ap[:, None]) - lp.gather(-1, ak[:, None]))[:, 0][flips]
    widest = gaps.max().item() if flips.any() else 0.0
    near_tie, err_bound = 2.0 * err_p, 2.0 * err_p + 1e-3
    cos = min(_cosine(a.double(), b.double()) for a, b in zip(lk, lp))
    print(f"  {label} {what}: logit cosine {cos:.6f} at worst; argmax differs at "
          f"{int(flips.sum())} {rows} (plain-path gaps at most {widest:.4g}, near-tie bound "
          f"{near_tie:.4g}); largest logit error from the fp32 witness: kernel {err_k:.4g}, plain "
          f"{err_p:.4g} (bound {err_bound:.4g})")
    checks += [(err_k <= err_bound, f"{label}: the kernel path's largest logit error from the "
                                    f"fp32 witness {err_k} > 2 x the plain path's {err_p} + 1e-3"),
               (widest <= near_tie, f"{label}: the kernel path decided a {rows[:-1]} otherwise "
                                    f"than the plain path across a gap of {widest} > {near_tie}")]
    return {"argmax_flips": int(flips.sum()), "flip_gap_max": widest, "near_tie_bound": near_tie,
            "logit_err_bound": err_bound, "logit_err_vs_fp32": {"kernel": err_k, "plain": err_p}}


def first_divergence(engine_toks: list, ref_toks: list, ref_logits: torch.Tensor, eos: int):
    """(position, generate's top-two logit gap there) of the first token
    where the engine's list and generate's differ (generate's cut after its
    EOS, as the engine cuts), or None when they are equal."""
    ref = list(ref_toks)
    if eos in ref:
        ref = ref[: ref.index(eos) + 1]
    for t, (a, b) in enumerate(zip(engine_toks, ref)):
        if a != b:
            top = ref_logits[t].topk(2).values
            return t, (top[0] - top[1]).item()
    if len(engine_toks) != len(ref):
        t = min(len(engine_toks), len(ref))
        top = ref_logits[min(t, ref_logits.shape[0] - 1)].topk(2).values
        return t, (top[0] - top[1]).item()
    return None


def hold_engine_tokens(label: str, requests: dict, references: dict, near_tie: float,
                       eos: int, checks: list) -> dict:
    """Every request's engine tokens against its input's tokens through
    generate alone: equal, or first differing where generate's top-two gap
    is within the near-tie bound.  ``requests``: key -> token lists;
    ``references``: key -> (tokens, logits [steps, V])."""
    n = equal = 0
    worst = 0.0
    for key, lists in requests.items():
        ref_toks, ref_logits = references[key]
        for toks in lists:
            n += 1
            div = first_divergence(toks, ref_toks, ref_logits, eos)
            if div is None:
                equal += 1
                continue
            t, gap = div
            worst = max(worst, gap)
            checks.append((gap <= near_tie, f"{label}: a request's engine tokens first differ "
                                            f"from generate's at step {t}, across a top-two gap "
                                            f"of {gap} > the near-tie bound {near_tie}"))
    print(f"  {label}: {equal} of {n} requests' engine tokens equal generate's in full; the "
          f"others first differ across top-two gaps of at most {worst:.4g} (near-tie bound "
          f"{near_tie:.4g})")
    checks.append((n > 0, f"{label}: no engine request was recorded"))
    return {"requests": n, "equal_share": equal / n if n else 0.0, "divergence_gap_max": worst}


def _clients(post, jobs: list) -> tuple[list, float]:
    """Run each client's jobs (a list of callables, in order) on its own
    thread; (every job's seconds, wall seconds)."""
    import threading

    lat, errors = [], []
    lock = threading.Lock()

    def run(my_jobs):
        for job in my_jobs:
            try:
                dt = post(job)
            except Exception as e:  # noqa: BLE001 (reported after the join)
                errors.append(e)
                return
            with lock:
                lat.append(dt)

    threads = [threading.Thread(target=run, args=(j,)) for j in jobs]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return lat, wall


def _latency(lat: list) -> dict:
    ms = sorted(x * 1e3 for x in lat)
    return {"p50_ms": statistics.median(ms), "p90_ms": float(np.percentile(ms, 90)),
            "requests": len(ms)}


def discrete_exp(dataset: str = "", out: str = "", micro: int = 2, steps: int = 1,
                 layers: int = 32):
    """DiscreteVLAExp at its defaults (LLaMA-2-7B + CLIP-L/336, 7 x 255
    bins) with CLIP's 336 processor and ``layers`` decoder layers; training:
    ``dataset``, the LLM frozen (a 7B full fine-tune waits on the parallel
    layer), bf16, remat, rows of the collator's TRAIN_SEQ_LEN."""
    from dexbotic_tpu_torch.exp import base_exp
    from dexbotic_tpu_torch.exp.discrete_vla_exp import DiscreteVLAExp, DiscreteVLAModelConfig
    from dexbotic_tpu_torch.exp.optim import OptimizerConfig
    from dexbotic_tpu_torch.exp.trainer import TrainerConfig
    from dexbotic_tpu_torch.models import presets

    model = DiscreteVLAModelConfig()
    if layers != presets.LLM_PRESETS[model.llm_preset].num_layers:
        name = f"{model.llm_preset}_{layers}_layers"
        presets.LLM_PRESETS[name] = dataclasses.replace(
            presets.LLM_PRESETS[model.llm_preset], num_layers=layers)
        model = dataclasses.replace(model, llm_preset=name)
    return DiscreteVLAExp(
        model=model,
        data=base_exp.DataConfig(dataset_name=dataset, image_processor="clip_336"),
        trainer=TrainerConfig(output_dir=out, max_steps=steps, per_device_batch_size=micro,
                              logging_steps=1, save_steps=steps, bf16=True,
                              gradient_checkpointing=True, resume=False, save_optimizer=False),
        optimizer=OptimizerConfig(learning_rate=2e-5, freeze_llm=True), device="cuda")


def phase_discrete_serve(failures: list) -> dict:
    """Phase 14a: Discrete VLA-7B at DISCRETE_SERVE_LAYERS decoder layers
    (seeded bf16 weights, max_retries=1) served by DiscreteVLAServer over
    HTTP with continuous_batching=8 (8 clients x DISCRETE_CLIENT_REQUESTS
    requests at once, one-shot admissions; every request's text fails to
    parse and takes the sampled retries, discrete_vla_inference_action,
    which is what the server runs without the engine; 14e serves the engine
    with prefill_chunk=512 at all 32 layers).  Around each
    route: K1 counted and its shapes recorded (all among phase 3's), no K2,
    K3, K4 or plain CUDA attention call; on the engine routes ticks served
    several slots, and every request's engine tokens equal its input's
    tokens through generate alone or first differ at a near-tie (13a's rule,
    the bound from one request teacher-forced against an fp32 witness).
    p50/p90 a request, generated tokens/s, mean live slots and ms a tick,
    the largest gap between ticks around an admission, the idle share of a
    full tick, the share of requests whose text parsed.  Returns the model
    in fp32 (the witness) for 14b."""
    import dataclasses as dc

    from dexbotic_tpu_torch.exp.serve import DiscreteVLAServer
    from dexbotic_tpu_torch.models.generate import generate
    from dexbotic_tpu_torch.models.vlm import vlm_forward
    
    exp = discrete_exp(layers=DISCRETE_SERVE_LAYERS)
    t0 = time.perf_counter()
    cfg, model, norms = exp.load_for_inference()
    cfg = dc.replace(cfg, max_retries=DISCRETE_RETRIES)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    tok = exp.tokenizer.build_tokenizer()
    eos = tok.eos_token_id
    print(f"phase 14a: Discrete VLA-7B at {cfg.vlm.llm.num_layers} of 32 decoder layers "
          f"({n_params / 1e9:.3f}B params, bf16, built in {time.perf_counter() - t0:.1f} s) served "
          f"through DiscreteVLAServer: greedy, {cfg.max_new_tokens} new tokens, "
          f"max_retries={cfg.max_retries}")
    pngs = [_frame_png(200 + i) for i in range(DISCRETE_CLIENTS)]
    checks: list = []
    routes, engine_tokens, shapes_all = {}, {}, set()

    def key(ids, images, embeds):
        return hash(np.asarray(images).tobytes())

    for route, slots, chunk in (("engine", DISCRETE_SLOTS, 0),):
        server = DiscreteVLAServer(exp, cfg, model, tok, norms, host="127.0.0.1", port=0,
                                   continuous_batching=slots, prefill_chunk=chunk)
        probe = EngineProbe(server.engine, key) if slots else None
        httpd = server.serve_background()
        port = httpd.server_address[1]
        replies = []

        def post(png):
            out, dt = _post(port, LIBERO_PROMPT, [png])
            replies.append(out.item())
            return dt

        try:
            post(pngs[0])  # warm-up
            replies.clear()
            shapes: set = set()
            _zero_counts()
            with k1_calls(shapes):
                if slots:
                    lat, wall = _clients(post, [[png] * DISCRETE_CLIENT_REQUESTS for png in pngs])
                else:
                    lat, wall = _clients(post, [pngs])
            launches = _launch_counts()
            idle = None
            if slots and not chunk:  # one full tick of the idle engine, traced
                eng = server.engine
                idle = tick_parts(eng, DISCRETE_PROMPT_TOKENS)
        finally:
            httpd.shutdown()
            httpd.server_close()
            server.close()
        n_tok = (sum(len(t) for lists in probe.tokens.values() for t in lists) if slots
                 else len(lat) * cfg.max_new_tokens)
        row = {**_latency(lat), "wall_s": wall, "generated_tokens_per_s": n_tok / wall,
               "launches": launches, "k1_shapes": sorted(shapes),
               "parsed": server.parsed, "unparsed": server.unparsed,
               "parsed_share": server.parsed / max(server.parsed + server.unparsed, 1)}
        if slots:
            row.update(probe.summary())
            engine_tokens[route] = probe.tokens
        if idle is not None:
            row["tick_trace"] = idle
        routes[route] = row
        shapes_all |= shapes
        print(f"  {route}: {row['requests']} requests p50 {row['p50_ms']:.1f} ms, p90 "
              f"{row['p90_ms']:.1f} ms; {row['generated_tokens_per_s']:.1f} generated tokens/s; "
              f"parsed {server.parsed} of {server.parsed + server.unparsed}; K1 "
              f"{launches['flash_fwd']}, others {launches}; shapes {sorted(shapes)}")
        if slots:
            print(f"    ticks {row['ticks']} (batched {row['batched_steps']}), mean live slots "
                  f"{row['mean_live_slots']:.2f}, ms a full tick {row['ms_a_tick_full']}, a token "
                  f"{row['ms_a_token_full']}; admissions {row['admissions']}, largest gap between "
                  f"ticks around one: {row['max_tick_gap_admission_ms']} ms one-shot, "
                  f"{row['max_tick_gap_chunked_admission_ms']} ms chunked")
        if idle is not None:
            print(f"    one full tick ({eng.k} steps, {eng.S} slots) traced: {idle['tick_ms']:.1f} "
                  f"ms, device busy {idle['device_busy_ms']:.1f} ms over {idle['kernels']} kernels, "
                  f"idle {idle['idle_share']:.1%}")
        checks += [(launches["flash_fwd"] > 0, f"14a {route}: no K1 launch"),
                   (launches["flash_bwd"] == launches["dit_sample"] == launches["quant_matmul"]
                    == launches["plain_cuda_calls"] == 0, f"14a {route}: launches {launches}"),
                   (all(len(r["actions"]) == cfg.action_dim and all(math.isfinite(a) for a in
                                                                  r["actions"]) for r in replies),
                    f"14a {route}: a reply without {cfg.action_dim} finite actions")]
        if slots:
            checks.append((row["batched_steps"] > 0, f"14a {route}: no tick served two slots"))
        free_memory()

    # the references: each input through generate alone, its steps' logits recorded
    references, first = {}, None
    for png in pngs:
        ids, imgs = DiscreteVLAServer._prepare(
            types.SimpleNamespace(exp=exp, cfg=cfg, tokenizer=tok), {"text": LIBERO_PROMPT},
            [("f", png)])
        ids_t = torch.from_numpy(ids)[None].cuda()
        imgs_t = torch.from_numpy(imgs)[None].cuda()
        logits: list = []
        with torch.no_grad(), decode_logits(logits):
            toks, _ = generate(model.vlm, cfg.vlm, ids_t, torch.ones_like(ids_t), imgs_t,
                               cfg.max_new_tokens, eos)
        references[hash(imgs.tobytes())] = (toks[0].tolist(), torch.cat(logits))
        first = first or (ids_t, imgs_t)
    n_prompt = first[0].shape[1]
    checks.append((n_prompt == DISCRETE_PROMPT_TOKENS,
                   f"14a: the prompt is {n_prompt} tokens; phase 3 holds K1 at "
                   f"{DISCRETE_PROMPT_TOKENS}"))
    plain = plain_config(cfg)
    ids_t, imgs_t = first
    witness = hold_decode(
        "14a", model, lambda: model.vlm.llm, cfg.vlm.llm, n_prompt,
        lambda: generate(model.vlm, cfg.vlm, ids_t, torch.ones_like(ids_t), imgs_t,
                         cfg.max_new_tokens, eos)[0],
        lambda toks: vlm_forward(model.vlm, plain.vlm, torch.cat([ids_t, toks[:, :-1]], 1),
                                 torch.ones(1, n_prompt + toks.shape[1] - 1, dtype=torch.int32,
                                            device="cuda"), images=imgs_t),
        eos, checks)
    held = {route: hold_engine_tokens(f"14a {route}", engine_tokens[route], references,
                                      witness["near_tie_bound"], eos, checks)
            for route in engine_tokens}
    unchecked = sorted(shapes_all - K1_DISCRETE_CHECKED)
    checks.append((not unchecked and shapes_all,
                   f"14a: K1 took shapes phase 3 does not hold: {unchecked}"))
    failures.extend(msg for ok, msg in checks if not ok)
    for route, h in held.items():
        routes[route]["vs_generate"] = h
    return {"params": n_params, "prompt_tokens": n_prompt, "routes": routes, **witness,
            "model": model, "cfg": cfg, "exp": exp, "tokenizer": tok}


def phase_discrete_train_compare(failures: list, dataset: str, model, cfg) -> dict:
    """Phase 14b (a): Discrete VLA-7B trained (DiscreteVLAExp on
    write_suite's suite, the LLM frozen): one step at micro-batch 2 on 14a's
    weights (its DISCRETE_SERVE_LAYERS layers) in fp32: the kernel path (K1, K3 on q, k, v rounded to bf16), the
    plain path (K1's plain version on the same rounded q, k, v) and bf16
    weights (the Trainer's rule) against the fp32 witness (loss, grad_norm,
    the gradient 1-cosine of the projector and the tower), 10a's rule."""
    from dexbotic_tpu_torch.data.collator import Collator
    from dexbotic_tpu_torch.exp.optim import global_norm, is_frozen
    from dexbotic_tpu_torch.models.discrete_vla import build_discrete_vla, discrete_vla_loss
    from dexbotic_tpu_torch.ops.attention import flash_attention, flash_attention_bwd

    exp = discrete_exp(dataset, "out_discrete_compare", 2, 1)
    exp._auto_compute_norm_stats()
    tok = exp.tokenizer.build_tokenizer()
    ds = exp.data.build_data(exp.build_tokenization(tok), exp.action.build_action_process_func())
    n_tok = max(len(ds[i]["input_ids"]) for i in range(len(ds)))
    host = Collator(pad_token_id=tok.pad_token_id,
                    max_length=exp.tokenizer.model_max_length)([ds[0], ds[5]])
    batch = {k: torch.from_numpy(np.asarray(v)).cuda() for k, v in host.items()}
    print(f"phase 14b: one Discrete VLA-7B training step (micro-batch 2, fp32, LLM frozen, "
          f"samples of up to {n_tok} tokens padded to {batch['input_ids'].shape[1]}): kernel "
          f"path vs plain path vs fp32 witness; bf16 weights as a reading")
    checks = [(n_tok == DISCRETE_TRAIN_TOKENS and batch["input_ids"].shape[1] == TRAIN_SEQ_LEN,
               f"14b: samples of {n_tok} tokens padded to {batch['input_ids'].shape[1]}: phases "
               f"3 and 6 hold K1 and K3 at {DISCRETE_TRAIN_TOKENS} of {TRAIN_SEQ_LEN}")]
    plain = plain_config(cfg)
    watched = {"projector": ("vlm.projector.",), "vit": ("vlm.vit.",)}
    trainable = {n for n, _ in model.named_parameters() if not is_frozen(n, exp.optimizer)}
    torch.cuda.reset_peak_memory_stats()

    def run(m, c):
        for n, p in m.named_parameters():
            p.requires_grad_(n in trainable)
        n0 = (flash_attention.launches, flash_attention_bwd.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.enable_grad():
            loss, _ = discrete_vla_loss(m, c, batch, remat=True)
            loss.backward()
        torch.cuda.synchronize()
        named = [(n, p.grad) for n, p in m.named_parameters() if p.grad is not None]
        out = {"loss": float(loss.detach()), "grad_norm": float(global_norm([x for _, x in named])),
               "launches": (flash_attention.launches - n0[0], flash_attention_bwd.launches - n0[1]),
               "s": time.perf_counter() - t0}
        grads = {k: torch.cat([x.float().flatten() for n, x in named if n.startswith(prefixes)])
                 for k, prefixes in watched.items()}
        for p in m.parameters():
            p.grad = None
        m.requires_grad_(False)
        return out, grads

    w32, g32 = run(model, plain)
    with decoder_plain_on_bf16():
        wpl, gpl = run(model, plain)
    wk, gk = run(model, cfg)
    bf, rule = trainer_rule_copy(build_discrete_vla, plain, model, "14b's bf16 copy")
    wbf, gbf = run(bf, plain)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del bf
    free_memory()
    for label, w in (("kernel", wk), ("plain", wpl), ("bf16", wbf), ("fp32 witness", w32)):
        print(f"  {label}: loss {w['loss']:.6g} grad_norm {w['grad_norm']:.6g}; K1/K3 launches "
              f"{w['launches']}; {w['s']:.2f} s")
    checks += [(all(math.isfinite(wk[k]) for k in ("loss", "grad_norm")),
                f"14b: non-finite kernel-path metrics {wk}"),
               (wk["launches"][1] >= cfg.vlm.llm.num_layers
                and w32["launches"] == wpl["launches"] == wbf["launches"] == (0, 0),
                f"14b: K1/K3 launches kernel path {wk['launches']}, plain paths "
                f"{wpl['launches']} {w32['launches']} {wbf['launches']}")]
    witness, bounds = hold_step("14b", {"kernel": (wk, gk), "plain": (wpl, gpl),
                                        "bf16": (wbf, gbf)}, (w32, g32),
                                {"loss": "rel", "grad_norm": "rel"}, checks)
    failures.extend(msg for ok, msg in checks if not ok)
    del g32, gpl, gk, gbf, batch
    return {"prompt_tokens": n_tok, "kernel": wk, "plain": wpl, "bf16": wbf,
            "fp32_witness": w32, "vs_fp32": witness, "bounds": bounds, "peak_gib": peak, **rule}


def phase_discrete_train_steps(failures: list, dataset: str, cfg) -> dict:
    """Phase 14b (b): DISCRETE_TRAIN_STEPS steps of DiscreteVLAExp.train() at
    micro-batch 8 through recorded_train: s a step, peak, K1 and K3 launches
    and shapes, no K2, K4 or plain call."""
    steps_exp = discrete_exp(dataset, "out_discrete", DISCRETE_TRAIN_MICRO, DISCRETE_TRAIN_STEPS)
    rec = recorded_train(steps_exp, "out_discrete")
    rows, launches = rec["rows"], rec["launches"]
    step_s = statistics.median(1 / r["steps_per_sec"] for r in rows[1:])
    peak_steps = max(s["peak_gib"] for s in rec["seen"])
    print(f"phase 14b: {DISCRETE_TRAIN_STEPS} steps of DiscreteVLAExp.train() (micro-batch "
          f"{DISCRETE_TRAIN_MICRO}, bf16, LLM frozen): losses {[round(r['loss'], 4) for r in rows]}, "
          f"{step_s:.3f} s a step (median of steps 2-), peak {peak_steps:.2f} GiB, wall "
          f"{rec['wall']:.1f} s; launches {launches}; K1 shapes {sorted(rec['k1_shapes'])}, K3 "
          f"{sorted(rec['k3_shapes'])}")
    unchecked = sorted((rec["k1_shapes"] | rec["k3_shapes"]) - K1_DISCRETE_TRAIN_CHECKED)
    L = cfg.vlm.llm.num_layers
    checks = [(len(rows) == DISCRETE_TRAIN_STEPS and all(math.isfinite(r["loss"]) for r in rows),
                f"14b: {len(rows)} of {DISCRETE_TRAIN_STEPS} steps, losses {rows}"),
               (launches["flash_bwd"] >= L * DISCRETE_TRAIN_STEPS and launches["flash_fwd"]
                >= L * DISCRETE_TRAIN_STEPS and launches["dit_sample"] == launches["quant_matmul"]
                == launches["plain_cuda_calls"] == 0, f"14b: launches {launches}"),
               (not unchecked, f"14b: K1/K3 took shapes phases 3 and 6 do not hold: {unchecked}")]
    failures.extend(msg for ok, msg in checks if not ok)
    return {"step_s": step_s, "peak_gib": peak_steps, "launches": launches,
            "losses": [r["loss"] for r in rows], "wall_s": rec["wall"],
            "k1_shapes": sorted(rec["k1_shapes"]), "k3_shapes": sorted(rec["k3_shapes"])}


def phase_discrete(failures: list) -> dict:
    """Phase 14a, then 14b on its weights, in a temp dir (the suite, norm
    statistics, checkpoints), removed after."""
    serve = phase_discrete_serve(failures)
    model, cfg = serve.pop("model"), serve.pop("cfg")
    for k in ("exp", "tokenizer"):
        serve.pop(k)
    free_memory()
    with tempfile.TemporaryDirectory() as tmp, working_dir(tmp):
        dataset = write_suite(os.path.join(tmp, "suite"), name="discrete")
        compare = phase_discrete_train_compare(failures, dataset, model, cfg)
        del model
        free_memory()
        steps = phase_discrete_train_steps(failures, dataset, cfg)
    free_memory()
    return {"14a_serve": serve, "14b_compare": compare, "14b_train": steps}


def phase_navila_fleet(failures: list, exp, cfg, model, tok) -> dict:
    """Phase 14c, run inside 13a on its bf16 model: NAVILA_FLEET_SLOTS
    NaVILAInferenceSessions on one make_shared_engine(slots=4,
    max_prompt=2240, prefill_chunk=512), each fed its own 8-frame history
    from its own thread, a request at a time.  Each request's tokens are
    held against the same session's request without the engine (generate
    alone, logits recorded) once 13a has its near-tie bound (the returned
    ``hold`` does it).  K1 counted and its shapes recorded, decode ms a token
    with 4 live slots, p50/p90, the largest gap between ticks during the
    chunked admissions."""
    from dexbotic_tpu_torch.exp.navila_exp import NaVILAInferenceSession
    from dexbotic_tpu_torch.models.generate import generate

    S, R = NAVILA_FLEET_SLOTS, NAVILA_FLEET_REQUESTS
    print(f"phase 14c: {S} NaVILA sessions on one shared engine ({S} slots, max_prompt "
          f"{NAVILA_FLEET_MAX_PROMPT}, prefill_chunk {NAVILA_FLEET_CHUNK}), {R} requests each "
          f"from {S} threads")
    engine = NaVILAInferenceSession.make_shared_engine(
        cfg, model, slots=S, max_new_tokens=NAVILA_FLEET_NEW, max_prompt=NAVILA_FLEET_MAX_PROMPT,
        prefill_chunk=NAVILA_FLEET_CHUNK)
    probe = EngineProbe(engine, lambda ids, images, embeds: hash(np.asarray(images).tobytes()))
    frames = [[bgr_frame(_frame_png(400 + (3 + R) * i + j)) for j in range(3 + R)]
              for i in range(S)]
    sessions = [NaVILAInferenceSession(exp, cfg, model, tok, engine=engine,
                                       max_new_tokens=NAVILA_NEW_TOKENS) for _ in range(S)]
    for sess, fr in zip(sessions, frames):
        for f in fr[:3]:
            sess.observe(f)
    texts = [[] for _ in range(S)]
    shapes: set = set()

    def job(i):
        def ask():
            t0 = time.perf_counter()
            texts[i].append(sessions[i].act(frames[i][3 + len(texts[i])], NAVILA_INSTRUCTION))
            return time.perf_counter() - t0
        return ask

    _zero_counts()
    try:
        with k1_calls(shapes):
            lat, wall = _clients(lambda f: f(), [[job(i)] * R for i in range(S)])
        launches = _launch_counts()
    finally:
        engine.close()
    summary = probe.summary()
    # the references: the same sessions' requests without the engine
    references = {}
    for i in range(S):
        ref = NaVILAInferenceSession(exp, cfg, model, tok, max_new_tokens=NAVILA_NEW_TOKENS)
        for f in frames[i][:3]:
            ref.observe(f)
        for f in frames[i][3: 3 + R]:
            ids, imgs = ref.host_inputs(f, NAVILA_INSTRUCTION)
            ids_t = torch.tensor([ids], dtype=torch.int32, device="cuda")
            logits: list = []
            with torch.no_grad(), decode_logits(logits):
                toks, _ = generate(model.vlm, cfg.vlm, ids_t, torch.ones_like(ids_t),
                                   torch.from_numpy(imgs)[None].cuda(), NAVILA_NEW_TOKENS,
                                   ref.eos_token_id)
            row = toks[0].tolist()
            references[hash(imgs.tobytes())] = (row, torch.cat(logits))
    eos = sessions[0].eos_token_id
    # the engine route stops at the EOS id and at 0: generate's tokens cut the same way
    engine_toks = {}
    for k, lists in probe.tokens.items():
        engine_toks[k] = [_cut(t, (eos, 0)) for t in lists]
    refs = {k: (_cut(t, (eos, 0)), lg) for k, (t, lg) in references.items()}
    row = {**_latency(lat), "wall_s": wall, "launches": launches, "k1_shapes": sorted(shapes),
           **summary, "texts": texts}
    print(f"  {S * R} requests p50 {row['p50_ms']:.1f} ms, p90 {row['p90_ms']:.1f} ms; decode "
          f"{summary['ms_a_token_full']} ms a token with {S} live slots; ticks {summary['ticks']}, "
          f"mean live slots {summary['mean_live_slots']:.2f}; largest gap between ticks during a "
          f"chunked admission {summary['max_tick_gap_chunked_admission_ms']} ms; K1 "
          f"{launches['flash_fwd']}, shapes {sorted(shapes)}")
    unchecked = sorted(shapes - K1_NAVILA_FLEET_CHECKED)
    checks = [(launches["flash_fwd"] > 0 and launches["flash_bwd"] == launches["dit_sample"]
               == launches["quant_matmul"] == launches["plain_cuda_calls"] == 0,
               f"14c: launches {launches}"),
              (not unchecked and shapes, f"14c: K1 took shapes phase 3 does not hold: {unchecked}"),
              (all(len(t) == R for t in texts), f"14c: texts {texts}")]
    failures.extend(msg for ok, msg in checks if not ok)

    def hold(near_tie: float) -> dict:
        later: list = []
        out = hold_engine_tokens("14c", engine_toks, refs, near_tie, -1, later)
        failures.extend(msg for ok, msg in later if not ok)
        return out

    return {**row, "hold": hold}


def _cut(toks: list, stops: tuple) -> list:
    for stop in stops:
        if stop in toks:
            toks = toks[: toks.index(stop)]
    return list(toks)


def bgr_frame(png: bytes) -> np.ndarray:
    """A PNG's frame in BGR, as NaVILAServer.frame gives it."""
    from dexbotic_tpu_torch.exp.serve import _decode_frames

    frames, order = _decode_frames([png])
    return frames[0] if order == "bgr" else frames[0][..., ::-1]


def muvla_batch(server, tok, pngs: list, device="cuda") -> dict:
    """14d's training batch: two rows of the served prompt (a map view and
    MUVLA_VIEWS observation views) + an answer of MUVLA_ANSWERS + EOS,
    labels on the answer, right-padded; a reward a row."""
    from dexbotic_tpu_torch.constants import IGNORE_INDEX

    rows, labels, maps, obs = [], [], [], []
    for i, answer in enumerate(MUVLA_ANSWERS):
        files = [("f", p) for p in pngs[i * (1 + MUVLA_VIEWS): (i + 1) * (1 + MUVLA_VIEWS)]]
        ids, m, o = server._prepare({"text": MUVLA_INSTRUCTIONS[i]}, files)
        ans = tok.encode(answer, add_bos=False) + [tok.eos_token_id]
        rows.append(ids[0].tolist() + ans)
        labels.append([IGNORE_INDEX] * ids.shape[1] + ans)
        maps.append(m)
        obs.append(o)
    L = max(len(r) for r in rows)
    ids = torch.zeros(len(rows), L, dtype=torch.int32)
    lab = torch.full((len(rows), L), IGNORE_INDEX, dtype=torch.int32)
    mask = torch.zeros(len(rows), L, dtype=torch.int32)
    for b, (r, lb) in enumerate(zip(rows, labels)):
        ids[b, : len(r)] = torch.tensor(r)
        lab[b, : len(lb)] = torch.tensor(lb)
        mask[b, : len(r)] = 1
    return {"input_ids": ids.to(device), "labels": lab.to(device), "attention_mask": mask.to(device),
            "map_images": torch.cat(maps).to(device), "obs_images": torch.cat(obs).to(device),
            "reward": torch.tensor([0.8, -0.3], device=device)}


def phase_muvla(failures: list) -> dict:
    """Phase 14d: MUVLA-7B (the example recipe's defaults: LLaMA-2-7B, two
    CLIP-L/336 towers, a fuser of 1024 and 192 history queries; seeded bf16
    weights) served by MUVLAServer over HTTP (a map view + 4 observation
    views a request) without the engine (MUVLA_SEQUENTIAL requests in sequence), then with
    continuous_batching=4 (the embeds route) from 4 client threads; K1
    counted and its shapes held to phase 3's; the engine's tokens against
    generate alone by 13a's near-tie rule; p50/p90, the fuse time (towers +
    QFormer + fuser).  Then one muvla_loss step with a reward at
    micro-batch 2 on the weights in fp32, the LLM frozen: kernel path vs
    plain path vs bf16 weights (the Trainer's rule) against the fp32 witness (10a's rule; the
    gradient 1-cosine of the projector, the fuser, the QFormer, the
    observation tower and the reward head), the step's s and peak."""
    from dexbotic_tpu_torch.exp.optim import OptimizerConfig, global_norm, is_frozen
    from dexbotic_tpu_torch.exp.serve import MUVLAServer
    from dexbotic_tpu_torch.models.muvla import build_muvla, fuse_obs_with_history, muvla_generate, muvla_loss
    from dexbotic_tpu_torch.models.vlm import splice_image_embeds, vlm_forward
    from dexbotic_tpu_torch.nn.transformer import embed_tokens
    from dexbotic_tpu_torch.ops.attention import flash_attention, flash_attention_bwd
    from dexbotic_tpu_torch.playground.example_muvla_exp import MyMUVLAExp
    from script.profile_pi0_torch import wall_ms

    exp = MyMUVLAExp(device="cuda")
    t0 = time.perf_counter()
    cfg, model, _ = exp.load_for_inference()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    tok = exp.tokenizer.build_tokenizer()
    eos = tok.eos_token_id
    print(f"phase 14d: MUVLA-7B ({n_params / 1e9:.3f}B params, bf16, built in "
          f"{time.perf_counter() - t0:.1f} s) served through MUVLAServer: a map view + "
          f"{MUVLA_VIEWS} observation views, greedy, {MUVLA_NEW} new tokens")
    pngs = [_frame_png(300 + i) for i in range((1 + MUVLA_VIEWS) * MUVLA_SLOTS)]
    views = [pngs[i * (1 + MUVLA_VIEWS): (i + 1) * (1 + MUVLA_VIEWS)] for i in range(MUVLA_SLOTS)]
    checks: list = []
    routes, engine_tokens, shapes_all = {}, None, set()
    for route, slots in (("sequential", 0), ("engine", MUVLA_SLOTS)):
        server = MUVLAServer(exp, cfg, model, tok, host="127.0.0.1", port=0,
                             max_new_tokens=MUVLA_NEW, continuous_batching=slots)
        probe = (EngineProbe(server.engine, lambda ids, images, embeds: tuple(np.asarray(ids)))
                 if slots else None)
        httpd = server.serve_background()
        port = httpd.server_address[1]

        def post(i):
            _, dt = _post(port, MUVLA_INSTRUCTIONS[i], views[i])
            return dt

        try:
            post(0)  # warm-up
            shapes: set = set()
            _zero_counts()
            with k1_calls(shapes):
                if slots:
                    lat, wall = _clients(post, [[i] * MUVLA_CLIENT_REQUESTS for i in range(slots)])
                else:
                    lat, wall = _clients(post, [list(range(MUVLA_SEQUENTIAL))])
            launches = _launch_counts()
        finally:
            httpd.shutdown()
            httpd.server_close()
            server.close()
        row = {**_latency(lat), "wall_s": wall, "launches": launches, "k1_shapes": sorted(shapes)}
        if slots:
            row.update(probe.summary())
            engine_tokens = probe.tokens
        routes[route] = row
        shapes_all |= shapes
        print(f"  {route}: {row['requests']} requests p50 {row['p50_ms']:.1f} ms, p90 "
              f"{row['p90_ms']:.1f} ms; K1 {launches['flash_fwd']}, others {launches}; shapes "
              f"{sorted(shapes)}" + (f"; ticks {row['ticks']} (batched {row['batched_steps']}), "
                                    f"mean live slots {row['mean_live_slots']:.2f}" if slots else ""))
        checks += [(launches["flash_fwd"] > 0 and launches["flash_bwd"] == launches["dit_sample"]
                    == launches["quant_matmul"] == launches["plain_cuda_calls"] == 0,
                    f"14d {route}: launches {launches}")]
        if slots:
            checks.append((row["batched_steps"] > 0, f"14d {route}: no tick served two slots"))
        free_memory()
    # the references, the fuse time and one request against the fp32 witness
    server = MUVLAServer(exp, cfg, model, tok, max_new_tokens=MUVLA_NEW)
    references, inputs = {}, []
    with torch.no_grad():
        for i in range(MUVLA_SLOTS):
            ids, m, o = server._prepare({"text": MUVLA_INSTRUCTIONS[i]}, [("f", p) for p in views[i]])
            logits: list = []
            with decode_logits(logits):
                toks, _ = muvla_generate(model, cfg, ids, torch.ones_like(ids), m, o, MUVLA_NEW, eos)
            references[tuple(ids[0].tolist())] = (toks[0].tolist(), torch.cat(logits))
            inputs.append((ids, m, o))
        ids, m, o = inputs[0]
        fuse_ms = wall_ms(lambda: fuse_obs_with_history(model, cfg, m, o))
    n_prompt = ids.shape[1]
    checks.append((n_prompt == MUVLA_PROMPT_TOKENS, f"14d: the prompt is {n_prompt} tokens; "
                                                    f"phase 3 holds K1 at {MUVLA_PROMPT_TOKENS}"))
    plain = plain_config(cfg)

    def full_embeds(toks):
        prompt = splice_image_embeds(model, cfg.vlm, ids, fuse_obs_with_history(model, cfg, m, o))
        return torch.cat([prompt, embed_tokens(model.llm, cfg.vlm.llm, toks[:, :-1],
                                               dtype=prompt.dtype)], 1)

    witness = hold_decode(
        "14d", model, lambda: model.llm, cfg.vlm.llm, n_prompt,
        lambda: muvla_generate(model, cfg, ids, torch.ones_like(ids), m, o, MUVLA_NEW, eos)[0],
        lambda toks: vlm_forward(model, plain.vlm, torch.cat([ids, toks[:, :-1]], 1),
                                 torch.ones(1, n_prompt + toks.shape[1] - 1, dtype=torch.int32,
                                            device="cuda"), inputs_embeds=full_embeds(toks)),
        eos, checks)
    held = hold_engine_tokens("14d engine", engine_tokens, references,
                              witness["near_tie_bound"], eos, checks)
    routes["engine"]["vs_generate"] = held
    unchecked = sorted(shapes_all - K1_MUVLA_CHECKED)
    checks.append((not unchecked and shapes_all,
                   f"14d: K1 took shapes phase 3 does not hold: {unchecked}"))
    print(f"  fuse (two towers, QFormer, fuser, projector) {fuse_ms:.1f} ms a request")

    # one training step in fp32 (the witness left the weights there)
    batch = muvla_batch(server, tok, pngs)
    L = batch["input_ids"].shape[1]
    checks.append((L == MUVLA_TRAIN_TOKENS, f"14d: training rows of {L} tokens; phases 3 and 6 "
                                            f"hold K1 and K3 at {MUVLA_TRAIN_TOKENS}"))
    opt = OptimizerConfig(freeze_llm=True)
    trainable = {n for n, _ in model.named_parameters() if not is_frozen(n, opt)}
    watched = {"projector": ("projector.",), "fuser": ("fuser.",), "qformer": ("qformer.",),
               "obs_vit": ("obs_vit.",), "reward_head": ("reward_head.",)}
    torch.cuda.reset_peak_memory_stats()

    def run(mod, c):
        for n, p in mod.named_parameters():
            p.requires_grad_(n in trainable)
        n0 = (flash_attention.launches, flash_attention_bwd.launches)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.enable_grad():
            loss, metrics = muvla_loss(mod, c, batch, remat=True)
            loss.backward()
        torch.cuda.synchronize()
        named = [(n, p.grad) for n, p in mod.named_parameters() if p.grad is not None]
        out = {"loss": float(loss.detach()), "grad_norm": float(global_norm([x for _, x in named])),
               "reward_loss": float(metrics["reward_loss"].detach()),
               "launches": (flash_attention.launches - n0[0], flash_attention_bwd.launches - n0[1]),
               "s": time.perf_counter() - t1}
        grads = {k: torch.cat([x.float().flatten() for n, x in named if n.startswith(prefixes)])
                 for k, prefixes in watched.items()}
        for p in mod.parameters():
            p.grad = None
        mod.requires_grad_(False)
        return out, grads

    w32, g32 = run(model, plain)
    with decoder_plain_on_bf16():
        wpl, gpl = run(model, plain)
    wk, gk = run(model, cfg)
    bf, rule = trainer_rule_copy(build_muvla, plain, model, "14d's bf16 copy")
    wbf, gbf = run(bf, plain)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del bf
    for label, w in (("kernel", wk), ("plain", wpl), ("bf16", wbf), ("fp32 witness", w32)):
        print(f"  step {label}: loss {w['loss']:.6g} (reward {w['reward_loss']:.4g}) grad_norm "
              f"{w['grad_norm']:.6g}; K1/K3 launches {w['launches']}; {w['s']:.2f} s")
    print(f"  step peak {peak:.2f} GiB")
    checks += [(all(math.isfinite(wk[k]) for k in ("loss", "grad_norm")),
                f"14d: non-finite kernel-path metrics {wk}"),
               (wk["launches"][1] >= cfg.vlm.llm.num_layers
                and w32["launches"] == wpl["launches"] == wbf["launches"] == (0, 0),
                f"14d: K1/K3 launches kernel path {wk['launches']}, plain paths "
                f"{wpl['launches']} {w32['launches']} {wbf['launches']}")]
    vs, bounds = hold_step("14d", {"kernel": (wk, gk), "plain": (wpl, gpl),
                                   "bf16": (wbf, gbf)}, (w32, g32),
                           {"loss": "rel", "grad_norm": "rel"}, checks)
    failures.extend(msg for ok, msg in checks if not ok)
    del model, server, g32, gpl, gk, gbf, batch
    free_memory()
    return {"params": n_params, "prompt_tokens": n_prompt, "routes": routes,
            "fuse_ms": fuse_ms, **witness, "engine_tokens": engine_tokens,
            "train": {"kernel": wk, "plain": wpl, "bf16": wbf, "fp32_witness": w32,
                      "vs_fp32": vs, "bounds": bounds, "peak_gib": peak, **rule,
                      "launches": {"flash_fwd": wk["launches"][0], "flash_bwd": wk["launches"][1]}}}


# ---------------------------------------------------------------------------
# Phases 14e and 14f: the token-decoding policies served with int8 weights
# (inference_quantize "int8", then "w8a8") through the decode engine
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def quant_calls():
    """{route: calls} the package made while inside: K4's launches (its
    count) and quant_linear's calls of the dequantize formulation and of
    w8a8_matmul (wrappers on the two functions of ops/quant_matmul)."""
    import threading

    from dexbotic_tpu_torch.ops import quant_matmul as qm

    calls, lock = {"dequant": 0, "w8a8": 0}, threading.Lock()
    real = {"dequant": qm.quant_matmul_ref, "w8a8": qm.w8a8_matmul}

    def counted(route):
        def call(*args, **kw):
            with lock:
                calls[route] += 1
            return real[route](*args, **kw)
        return call

    n0 = qm.quant_matmul.launches
    qm.quant_matmul_ref, qm.w8a8_matmul = counted("dequant"), counted("w8a8")
    try:
        yield calls
    finally:
        qm.quant_matmul_ref, qm.w8a8_matmul = real["dequant"], real["w8a8"]
        calls["k4"] = qm.quant_matmul.launches - n0


def tower_passes(vit, vcfg, images: int) -> list:
    """The quantized products of a ViT over ``images`` frames: the patch
    embedding over their patches, the layers up to select_layer over their
    tokens (nn/vit.vit_forward)."""
    n = vcfg.num_layers + (vcfg.select_layer + 1 if vcfg.select_layer is not None else 0)
    return ([(vit.patch_embed, images * vcfg.num_patches)]
            + [(layer, images * vcfg.seq_len) for layer in vit.layers[:n]])


def head_passes(llm, rows: int, n: int) -> list:
    """``n`` calls of lm_logits over ``rows`` rows: the lm_head's products
    (a tied table is dequantized by lm_logits itself: none)."""
    return [(llm.lm_head, rows)] * n if hasattr(llm, "lm_head") else []


def generate_passes(vlm, vcfg, prompt: int, new: int, images: int) -> list:
    """The quantized products of one models/generate.generate call of one
    row: the tower and projector over ``images`` frames (0: the prompt's
    embeds are given), the prefill of ``prompt`` rows, ``new`` - 1 one-row
    steps and ``new`` lm_logits calls."""
    passes = []
    if images:
        passes += tower_passes(vlm.vit, vcfg.vit, images)
        passes.append((vlm.projector, images * vcfg.vit.num_output_tokens))
    passes += [(vlm.llm.layers, prompt)] + [(vlm.llm.layers, 1)] * (new - 1)
    return passes + head_passes(vlm.llm, 1, new)


def engine_passes(vlm, vcfg, eng, admissions: list, ticks: int, prompt: int,
                  images: int) -> list:
    """The quantized products of a decode engine's ``admissions`` (its
    admit_log entries) of prompts of ``prompt`` tokens with ``images``
    frames each (0: the embeds route) and of ``ticks`` ticks: an admission
    of B runs the tower and projector over B x ``images`` frames, then one
    prefill of B x bucket rows or, chunked, S x chunk rows a chunk up to the
    prompt's end; a tick runs ``eng.k`` steps of S rows and lm_logits."""
    passes = []
    for _, _, B, bucket, chunked in admissions:
        if images:
            passes += tower_passes(vlm.vit, vcfg.vit, B * images)
            passes.append((vlm.projector, B * images * vcfg.vit.num_output_tokens))
        if chunked:
            passes += [(vlm.llm.layers, eng.S * min(eng.chunk, bucket - off))
                       for off in range(0, prompt, eng.chunk)]
        else:
            passes.append((vlm.llm.layers, B * bucket))
    passes += [(vlm.llm.layers, eng.S)] * (ticks * eng.k)
    return passes + head_passes(vlm.llm, eng.S, ticks * eng.k)


def muvla_fuse_passes(model, cfg, views: int) -> list:
    """The quantized products of models/muvla.fuse_obs_with_history for one
    request of a map view and ``views`` observation views: the observation
    tower over the current view, then over the history; the QFormer's input
    projection and attention (its queries against the history's tokens); the
    map tower; the fuser (the observation tokens against the map's); the
    projector over the fused tokens."""
    ov, Q = cfg.obs_vit, cfg.num_history_queries
    passes = tower_passes(model.obs_vit, ov, 1)
    n_obs = ov.num_output_tokens
    if views > 1:
        mem = (views - 1) * ov.num_output_tokens
        a = model.qformer.attn
        passes += tower_passes(model.obs_vit, ov, views - 1)
        passes += [(model.qformer.input_proj, mem), (a.q, Q), (a.k, mem), (a.v, mem), (a.o, Q)]
        n_obs += Q
    passes += tower_passes(model.vit, cfg.vlm.vit, 1)
    n_map, f = cfg.vlm.vit.num_output_tokens, model.fuser.attn
    return passes + [(f.q, n_obs), (f.k, n_map), (f.v, n_map), (f.o, n_obs),
                     (model.projector, n_obs)]


@contextlib.contextmanager
def generate_calls(module, out: list):
    """Records every ``generate`` call made through ``module``'s name for it
    while inside: (images' bytes hash or None, prompt rows, new tokens,
    temperature, tokens, each step's logits [steps, V])."""
    call = module.generate

    def recorded(vlm, vcfg, ids, valid, images, max_new, eos, *args, temperature=0.0, **kw):
        logits: list = []
        with decode_logits(logits):
            toks, lp = call(vlm, vcfg, ids, valid, images, max_new, eos, *args,
                            temperature=temperature, **kw)
        key = None if images is None else hash(images.cpu().numpy().tobytes())
        out.append((key, ids.shape[1], max_new, temperature, toks[0].tolist(), torch.cat(logits)))
        return toks, lp

    module.generate = recorded
    try:
        yield out
    finally:
        module.generate = call


@torch.no_grad()
def first_step_logits(vlm, vcfg, ids, images=None, embeds=None, tok=None,
                      cache_dtype=torch.bfloat16):
    """generate's first decode step over a batch of whole prompts ``ids``
    [B, S] at once: the prefill into a cache of S + 1 columns, then one
    query row a prompt fed ``tok`` [B] (None: the prefill's argmax).
    (the step's logits fp32 [B, V], tok)."""
    from dexbotic_tpu_torch.models.vlm import vlm_forward
    from dexbotic_tpu_torch.nn.transformer import embed_tokens, init_kv_cache, lm_logits

    B, S = ids.shape
    cache = init_kv_cache(vcfg.llm, B, S + 1, dtype=cache_dtype, device=ids.device)
    hidden, cache = vlm_forward(vlm, vcfg, ids, torch.ones_like(ids), images=images,
                                inputs_embeds=embeds, cache=cache, update_cache=True)
    if tok is None:
        tok = lm_logits(vlm.llm, vcfg.llm, hidden[:, -1]).float().argmax(-1).to(torch.int32)
    emb = embed_tokens(vlm.llm, vcfg.llm, tok[:, None], dtype=hidden.dtype)
    pos = torch.full((B, 1), S, dtype=torch.int32, device=ids.device)
    hidden, _ = vlm_forward(vlm, vcfg, tok[:, None], torch.ones_like(pos), inputs_embeds=emb,
                            positions=pos, grp=pos + 1, cache=cache, update_cache=True)
    return lm_logits(vlm.llm, vcfg.llm, hidden[:, 0]).float(), tok


def hold_decode_step(label: str, model, vlm, vcfg, ids, checks: list, images=None,
                     embeds_fn=None) -> dict:
    """10c's rule on one decode step of B prompts at once (B = the engine's
    slots: K4's few-row tiles and the lm_head at the decode's rows): the
    kernel path (K1, and K4 on int8 weights), the plain path (the plain
    attention; on int8 weights the dequantize formulation, plain_int8) and
    an fp32 witness (every floating weight in fp32, the int8 q kept: the
    dequantized weights' values; the plain path without W8A8, an fp32
    cache), each fed
    the kernel path's first token: the kernel path's largest logit error
    from the witness <= 2x the plain path's + 1e-3, an argmax that differs
    from the plain path's only across a near-tie (its top-two gap <= 2x its
    largest error).  ``embeds_fn()`` gives the prompt's embeds where the
    policy splices them itself (MUVLA).  The model is left as it was found."""
    plain = dataclasses.replace(vcfg, llm=dataclasses.replace(vcfg.llm, attn_impl="xla"))
    emb = (lambda: None) if embeds_fn is None else embeds_fn
    k_logits, tok = first_step_logits(vlm, vcfg, ids, images, emb())
    with plain_int8():
        p_logits, _ = first_step_logits(vlm, plain, ids, images, emb(), tok)
    from dexbotic_tpu_torch.ops import quant_matmul as qm

    dtypes = {name: p.dtype for name, p in model.named_parameters()}
    w8a8, qm.W8A8_MIN_ROWS = qm.W8A8_MIN_ROWS, None  # the witness keeps every activation
    model.float()
    try:
        with plain_int8():
            w_logits, _ = first_step_logits(vlm, plain, ids, images, emb(), tok,
                                            cache_dtype=torch.float32)
    finally:
        qm.W8A8_MIN_ROWS = w8a8
        for name, p in model.named_parameters():
            p.data = p.data.to(dtypes[name])
    cos = min(_cosine(a.double(), b.double()) for a, b in zip(k_logits, p_logits))
    held = hold_logits(label, f"one decode step of {ids.shape[0]} prompts", "rows", k_logits,
                       p_logits, w_logits, checks)
    return {"rows": ids.shape[0], "logit_cosine_min": cos, **held}


def decode_weight_bytes(llm) -> int:
    """Bytes of the weights one decode step reads: every decoder layer's
    parameters and the lm_head's (int8 q and its scales where quantized; an
    embedding row a slot is left out)."""
    mods = [llm.layers, llm.norm] + ([llm.lm_head] if hasattr(llm, "lm_head") else [])
    return sum(nbytes(*m.parameters()) for m in mods)


def tick_parts(eng, prompt: int) -> dict:
    """One full tick (``eng.k`` steps, every slot live at ``prompt`` prompt
    tokens) of the idle engine, traced: its wall ms, the card's busy ms and
    idle share, and the device ms of K4, K1 and everything else."""
    from script.profile_pi0_torch import trace

    dev = eng.device
    args = (torch.full((eng.S,), prompt, dtype=torch.int32, device=dev),
            torch.zeros(eng.S, dtype=torch.int32, device=dev),
            torch.zeros(eng.S, dtype=torch.bool, device=dev),
            torch.full((eng.S,), eng.N, dtype=torch.int32, device=dev), eng.k)
    eng._step(*args)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    eng._step(*args)
    torch.cuda.synchronize()
    tick_ms = (time.perf_counter() - t1) * 1e3
    busy, n_kernels, by_name = trace(lambda: eng._step(*args))
    parts = {"k4": 0.0, "k1": 0.0, "other": 0.0}
    for name, ms in by_name.items():  # the kernels' own, not PyTorch's reduce_kernel
        ours = "anonymous namespace" in name or "_GLOBAL__N_" in name  # csrc's own kernels
        part = ("k4" if ours and any(k in name for k in K4_KERNELS)
                else "k1" if any(k in name for k in K1_KERNELS) else "other")
        parts[part] += ms
    return {"tick_ms": tick_ms, "device_busy_ms": busy, "kernels": n_kernels,
            "idle_share": 1 - busy / tick_ms, "host_ms": tick_ms - busy,
            "device_ms_by_part": parts}


def token_agreement(tokens: dict, ref: dict) -> dict:
    """Each request's engine tokens (EngineProbe.tokens) against the same
    input's first request in ``ref`` (another route's): the share of
    requests equal in full, and the mean share of a request's tokens before
    its first difference."""
    same, prefix = [], []
    for key, lists in tokens.items():
        want = ref[key][0]
        for toks in lists:
            n = next((i for i, (a, b) in enumerate(zip(toks, want)) if a != b),
                     min(len(toks), len(want)))
            same.append(toks == want)
            prefix.append(n / max(len(want), 1))
    return {"equal_share": statistics.mean(same), "mean_prefix_share": statistics.mean(prefix)}


def quant_route_checks(label: str, seen: dict, calls: dict, want: dict, shapes: set,
                       launches: dict, checks: list) -> None:
    """A quantized route's counts: the hooks' routes equal the rule's counts
    from the model, and the package's K4 launches, dequantize calls and
    w8a8 calls equal them; every K4 shape one phase 4c holds; no K2, K3 or
    plain attention call."""
    unheld = sorted((M, K, N, str(dt)) for M, K, N, dt in shapes - K4_CHECKED)
    checks += [(seen == want, f"{label}: the hooks' routes {seen} != the rule's {want}"),
               (calls == seen, f"{label}: the package's calls {calls} != the hooks' {seen}"),
               (not unheld, f"{label}: K4 took shapes phase 4c does not hold: {unheld}"),
               (launches["flash_fwd"] > 0 and launches["flash_bwd"] == launches["dit_sample"]
                == launches["plain_cuda_calls"] == 0, f"{label}: launches {launches}")]


class DigitDecode:
    """The exp's tokenizer, whose decode writes each token id as its number:
    a greedy decode then always parses (the first seven ids as bins), so the
    served requests measure the engine, not the sampled retries (with random
    weights a real decode never parses)."""

    def __init__(self, tok):
        self._tok = tok

    def __getattr__(self, name):
        return getattr(self._tok, name)

    def __call__(self, *args, **kw):
        return self._tok(*args, **kw)

    def decode(self, ids):
        return " ".join(str(int(i)) for i in ids)


def phase_discrete_quant(failures: list) -> dict:
    """Phase 14e: Discrete VLA-7B at all 32 decoder layers (seeded weights,
    max_retries=1) built by DiscreteVLAExp.load_for_inference(), served by
    DiscreteVLAServer over HTTP through the engine (8 slots,
    prefill_chunk=512), 8 clients x 1 request, three ways: bf16 (the
    reference), then the same model quantized in place by the exp's
    quantize_inference_model with inference_quantize="int8", then "w8a8"
    (W8A8_MIN_ROWS = 2048, restored after).  The server decodes with
    DigitDecode, so every client's text parses; in the "int8" route one
    more request then decodes with the exp's tokenizer, whose text does not
    parse (random weights), so that it takes discrete_vla_inference_action's
    retries on the quantized weights (a greedy and a sampled generate; the
    greedy one must equal generate alone's tokens).  Per route: the hooks' routes, K4's launches and the
    dequantize and w8a8 calls against the rule's counts from the model and
    the engine's admissions and ticks; K4 and K1 shapes among 4c's and 3's;
    no K2, K3 or plain call.  Per quantized route: each request's engine
    tokens equal to generate's alone or first differing at a near-tie
    (10c's rule on one decode step of the 8 prompts, hold_decode_step;
    "w8a8" takes "int8"'s references and retries, and its traced tick, where
    the rule sends none of their products to W8A8: both then run the same
    kernels on the same operands).  Readings: p50/p90, ms a full tick, a traced tick by
    part with the idle share, weight bytes a decode step, the peak, the
    quantized routes' agreement with the bf16 route's tokens."""
    from dexbotic_tpu_torch.exp.serve import DiscreteVLAServer
    from dexbotic_tpu_torch.models import discrete_vla as dv_mod
    from dexbotic_tpu_torch.ops import quant_matmul as qm

    exp = discrete_exp()
    t0 = time.perf_counter()
    cfg, model, norms = exp.load_for_inference()
    cfg = dataclasses.replace(cfg, max_retries=DISCRETE_RETRIES)
    torch.cuda.synchronize()
    tok = exp.tokenizer.build_tokenizer()
    eos = tok.eos_token_id
    print(f"phase 14e: Discrete VLA-7B at all {cfg.vlm.llm.num_layers} decoder layers "
          f"({sum(p.numel() for p in model.parameters()) / 1e9:.3f}B params, built in "
          f"{time.perf_counter() - t0:.1f} s) through the engine ({DISCRETE_SLOTS} slots, "
          f"prefill_chunk={DISCRETE_CHUNK}), {DISCRETE_CLIENTS} clients x 1 request: bf16, int8, w8a8")
    pngs = [_frame_png(200 + i) for i in range(DISCRETE_CLIENTS)]
    prepared = [DiscreteVLAServer._prepare(types.SimpleNamespace(exp=exp, cfg=cfg, tokenizer=tok),
                                           {"text": LIBERO_PROMPT}, [("f", png)]) for png in pngs]
    ids_b = torch.from_numpy(np.stack([i for i, _ in prepared])).cuda()
    imgs_b = torch.from_numpy(np.stack([m for _, m in prepared])).cuda()

    def key(ids, images, embeds):
        return hash(np.asarray(images).tobytes())

    checks, routes, tokens = [], {}, {}
    try:
        for mode in ("", "int8", "w8a8"):
            label = f"14e {mode or 'bf16'}"
            if mode:
                dataclasses.replace(exp, inference_quantize=mode).quantize_inference_model(model)
            checks.append((qm.W8A8_MIN_ROWS == (2048 if mode == "w8a8" else None),
                           f"{label}: W8A8_MIN_ROWS is {qm.W8A8_MIN_ROWS}"))
            # generate alone; "w8a8" repeats "int8"'s where the rule sends none of its products
            # to W8A8 (the same kernels on the same operands): its references and retries
            alone = generate_passes(model.vlm, cfg.vlm, DISCRETE_PROMPT_TOKENS, cfg.max_new_tokens, 1)
            own_generate = mode == "int8" or (mode == "w8a8"
                                              and quant_route_counts(alone)["w8a8"] > 0)
            server = DiscreteVLAServer(exp, cfg, model, DigitDecode(tok), norms, host="127.0.0.1",
                                       port=0, continuous_batching=DISCRETE_SLOTS,
                                       prefill_chunk=DISCRETE_CHUNK)
            eng = server.engine
            probe = EngineProbe(eng, key)
            httpd = server.serve_background()
            port = httpd.server_address[1]
            replies, gens, shapes, k4_shapes = [], [], set(), set()

            def post(png):
                out, dt = _post(port, LIBERO_PROMPT, [png])
                replies.append(out.item())
                return dt

            try:
                n_ticks, n_adm = len(probe.ticks), len(eng.admit_log)
                _zero_counts()
                torch.cuda.reset_peak_memory_stats()
                with (k1_calls(shapes), generate_calls(dv_mod, gens),
                      quant_routes_seen(model, k4_shapes) as seen, quant_calls() as calls):
                    lat, wall = _clients(post, [[png] for png in pngs])
                    n_tok = sum(len(t) for lists in probe.tokens.values() for t in lists)
                    summary = probe.summary()  # the clients' ticks
                    if own_generate:  # the exp's tokenizer: its text does not parse: the retries
                        server.tokenizer = tok
                        retry = _post(port, LIBERO_PROMPT, [pngs[0]])[0].item()
                launches = _launch_counts()
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                ticks = len(probe.ticks) - n_ticks
                one_tick = engine_passes(model.vlm, cfg.vlm, eng, [], 1, DISCRETE_PROMPT_TOKENS, 1)
                if mode == "w8a8" and quant_route_counts(one_tick)["w8a8"] == 0:
                    tick = routes["int8"]["tick_trace"]  # a tick runs int8's kernels
                else:
                    tick = tick_parts(eng, DISCRETE_PROMPT_TOKENS)
            finally:
                httpd.shutdown()
                httpd.server_close()
                server.close()
            passes = engine_passes(model.vlm, cfg.vlm, eng, eng.admit_log[n_adm:], ticks,
                                   DISCRETE_PROMPT_TOKENS, 1)
            for _, n_prompt, new, _, _, _ in gens:
                passes += generate_passes(model.vlm, cfg.vlm, n_prompt, new, 1)
            want = quant_route_counts(passes)
            held = vs = None
            if mode and not own_generate:
                references = references_int8
            elif mode:  # each input through generate alone, after the engine's requests
                refs: list = []
                with (torch.no_grad(), generate_calls(dv_mod, refs),
                      quant_routes_seen(model, k4_shapes)):
                    for ids, imgs in prepared:
                        dv_mod.generate(model.vlm, cfg.vlm, torch.from_numpy(ids)[None].cuda(),
                                        torch.ones(1, len(ids), dtype=torch.int32, device="cuda"),
                                        torch.from_numpy(imgs)[None].cuda(), cfg.max_new_tokens,
                                        eos)
                references = references_int8 = {k: (t, lg) for k, _, _, _, t, lg in refs}
            quant_route_checks(label, seen.routes(), dict(calls), want, k4_shapes, launches, checks)
            if mode:  # the retry request: a greedy and a sampled generate, no parse
                greedy = [c for c in gens if c[3] == 0.0]
                checks += [([c[3] for c in gens] == ([0.0, 1.0] if own_generate else [])
                            and server.unparsed == int(own_generate)
                            and server.parsed == DISCRETE_CLIENTS,
                            f"{label}: the retry request made generate calls at temperatures "
                            f"{[c[3] for c in gens]}; parsed {server.parsed}, unparsed "
                            f"{server.unparsed}"),
                           (all(c[4] == references[c[0]][0] for c in greedy),
                            f"{label}: the greedy retry's tokens differ from generate alone's on "
                            f"the same input")]
                if own_generate:
                    checks.append((len(retry["actions"]) == cfg.action_dim
                                   and all(math.isfinite(a) for a in retry["actions"]),
                                   f"{label}: the retry request's reply {retry}"))
                # the quantized model against itself: generate alone, K4 off, fp32
                held = hold_decode_step(label, model, model.vlm, cfg.vlm, ids_b, checks,
                                        images=imgs_b)
                vs = hold_engine_tokens(label, probe.tokens, references, held["near_tie_bound"],
                                        eos, checks)
            unchecked = sorted(shapes - K1_DISCRETE_CHECKED)
            row = {**_latency(lat), "wall_s": wall, "generated_tokens_per_s": n_tok / wall,
                   "launches": launches, "routes_seen": seen.routes(), "routes_rule": want,
                   "generate_calls": len(gens), "parsed": server.parsed,
                   "unparsed": server.unparsed, "k1_shapes": sorted(shapes),
                   "k4_shapes": sorted((M, K, N, str(dt)) for M, K, N, dt in k4_shapes),
                   "peak_gib": peak, "decode_weight_bytes": decode_weight_bytes(model.vlm.llm),
                   "tick_trace": tick, **summary, "decode_step": held, "vs_generate": vs}
            tokens[mode or "bf16"] = probe.tokens
            if mode:
                row["vs_bf16_tokens"] = token_agreement(probe.tokens, tokens["bf16"])
            routes[mode or "bf16"] = row
            checks += [(not unchecked and shapes, f"{label}: K1 took shapes phase 3 does not hold: "
                                                  f"{unchecked}"),
                       (row["batched_steps"] > 0, f"{label}: no tick served two slots"),
                       (len(replies) == DISCRETE_CLIENTS and all(
                           len(r["actions"]) == cfg.action_dim
                           and all(math.isfinite(a) for a in r["actions"]) for r in replies),
                        f"{label}: a reply without {cfg.action_dim} finite actions")]
            print(f"  {label}: {row['requests']} requests p50 {row['p50_ms']:.1f} ms, p90 "
                  f"{row['p90_ms']:.1f} ms; {row['generated_tokens_per_s']:.1f} generated tokens/s; "
                  f"ms a full tick {row['ms_a_tick_full']}; routes {seen.routes()} (rule {want}); "
                  f"launches {launches}; {len(gens)} generate calls; peak {peak:.2f} GiB; decode "
                  f"weights {row['decode_weight_bytes'] / 2 ** 30:.3f} GiB a step; traced tick "
                  f"{tick['tick_ms']:.1f} ms, idle {tick['idle_share']:.1%}, device by part "
                  f"{ {k: round(v, 3) for k, v in tick['device_ms_by_part'].items()} }"
                  + (f"; tokens vs bf16 {row['vs_bf16_tokens']}" if mode else ""))
            free_memory()
    finally:
        qm.W8A8_MIN_ROWS = None  # a process-wide global: no later int8 route runs under it
    failures.extend(msg for ok, msg in checks if not ok)
    del model
    free_memory()
    return {"prompt_tokens": DISCRETE_PROMPT_TOKENS, "routes": routes}


def phase_muvla_quant(failures: list, bf16_tokens: dict) -> dict:
    """Phase 14f: MUVLA-7B with 14d's seeded weights built by
    MUVLAExp.load_for_inference() with inference_quantize="int8", served by
    MUVLAServer through the engine (4 slots, the embeds route), 4 clients x
    1 request, then quantize_inference_model with "w8a8" (the same q and s;
    W8A8_MIN_ROWS = 2048, restored after) and the same again.  14e's checks
    and readings per route; each request's engine tokens against
    muvla_generate alone on the same input ("w8a8" takes "int8"'s, and its
    traced tick, as in 14e); agreement with 14d's bf16 engine tokens."""
    from dexbotic_tpu_torch.exp.serve import MUVLAServer
    from dexbotic_tpu_torch.models.muvla import fuse_obs_with_history, muvla_generate
    from dexbotic_tpu_torch.models.vlm import splice_image_embeds
    from dexbotic_tpu_torch.ops import quant_matmul as qm
    from dexbotic_tpu_torch.playground.example_muvla_exp import MyMUVLAExp

    exp = MyMUVLAExp(device="cuda", inference_quantize="int8")
    t0 = time.perf_counter()
    cfg, model, _ = exp.load_for_inference()
    torch.cuda.synchronize()
    tok = exp.tokenizer.build_tokenizer()
    eos = tok.eos_token_id
    print(f"phase 14f: MUVLA-7B ({sum(p.numel() for p in model.parameters()) / 1e9:.3f}B params "
          f"with int8 q, built and quantized in {time.perf_counter() - t0:.1f} s) through the "
          f"engine ({MUVLA_SLOTS} slots), {MUVLA_SLOTS} clients x 1 request: int8, w8a8")
    pngs = [_frame_png(300 + i) for i in range((1 + MUVLA_VIEWS) * MUVLA_SLOTS)]
    views = [pngs[i * (1 + MUVLA_VIEWS): (i + 1) * (1 + MUVLA_VIEWS)] for i in range(MUVLA_SLOTS)]
    checks, routes = [], {}
    try:
        for mode in ("int8", "w8a8"):
            label = f"14f {mode}"
            if mode == "w8a8":
                dataclasses.replace(exp, inference_quantize=mode).quantize_inference_model(model)
            checks.append((qm.W8A8_MIN_ROWS == (2048 if mode == "w8a8" else None),
                           f"{label}: W8A8_MIN_ROWS is {qm.W8A8_MIN_ROWS}"))
            server = MUVLAServer(exp, cfg, model, tok, host="127.0.0.1", port=0,
                                 max_new_tokens=MUVLA_NEW, continuous_batching=MUVLA_SLOTS)
            eng = server.engine
            probe = EngineProbe(eng, lambda ids, images, embeds: tuple(np.asarray(ids)))
            httpd = server.serve_background()
            port = httpd.server_address[1]
            inputs = [server._prepare({"text": MUVLA_INSTRUCTIONS[i]}, [("f", p) for p in views[i]])
                      for i in range(MUVLA_SLOTS)]
            shapes, k4_shapes, replies = set(), set(), []

            def post(i):
                out, dt = _post(port, MUVLA_INSTRUCTIONS[i], views[i])
                replies.append(out)
                return dt

            try:
                n_ticks, n_adm = len(probe.ticks), len(eng.admit_log)
                _zero_counts()
                torch.cuda.reset_peak_memory_stats()
                with (k1_calls(shapes), quant_routes_seen(model, k4_shapes) as seen,
                      quant_calls() as calls):
                    lat, wall = _clients(post, [[i] for i in range(MUVLA_SLOTS)])
                launches = _launch_counts()
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                ticks = len(probe.ticks) - n_ticks
                one_tick = engine_passes(model, cfg.vlm, eng, [], 1, MUVLA_PROMPT_TOKENS, 0)
                if mode == "w8a8" and quant_route_counts(one_tick)["w8a8"] == 0:
                    tick = routes["int8"]["tick_trace"]  # a tick runs int8's kernels
                else:
                    tick = tick_parts(eng, MUVLA_PROMPT_TOKENS)
            finally:
                httpd.shutdown()
                httpd.server_close()
                server.close()
            passes = engine_passes(model, cfg.vlm, eng, eng.admit_log[n_adm:], ticks,
                                   MUVLA_PROMPT_TOKENS, 0)
            passes += muvla_fuse_passes(model, cfg, MUVLA_VIEWS) * MUVLA_SLOTS
            want = quant_route_counts(passes)
            quant_route_checks(label, seen.routes(), dict(calls), want, k4_shapes, launches, checks)
            ref_shapes = set()
            alone = (muvla_fuse_passes(model, cfg, MUVLA_VIEWS)
                     + generate_passes(model, cfg.vlm, MUVLA_PROMPT_TOKENS, MUVLA_NEW, 0))
            if mode == "w8a8" and quant_route_counts(alone)["w8a8"] == 0:
                references = references_int8  # no product of generate alone reaches W8A8's rows
            else:  # each input through muvla_generate alone, after the engine's requests
                references = {}
                with torch.no_grad(), quant_routes_seen(model, ref_shapes):
                    for ids, m, o in inputs:
                        logits: list = []
                        with decode_logits(logits):
                            toks, _ = muvla_generate(model, cfg, ids, torch.ones_like(ids), m, o,
                                                     MUVLA_NEW, eos)
                        references[tuple(ids[0].tolist())] = (toks[0].tolist(), torch.cat(logits))
            references_int8 = references
            ids_b = torch.cat([i for i, _, _ in inputs])
            maps, obs = torch.cat([m for _, m, _ in inputs]), torch.cat([o for _, _, o in inputs])
            held = hold_decode_step(
                label, model, model, cfg.vlm, ids_b, checks,
                embeds_fn=lambda: splice_image_embeds(model, cfg.vlm, ids_b,
                                                      fuse_obs_with_history(model, cfg, maps, obs)))
            vs = hold_engine_tokens(label, probe.tokens, references, held["near_tie_bound"], eos,
                                    checks)
            unchecked = sorted(shapes - K1_MUVLA_CHECKED)
            unheld = sorted((M, K, N, str(dt)) for M, K, N, dt in ref_shapes - K4_CHECKED)
            row = {**_latency(lat), "wall_s": wall, "launches": launches,
                   "routes_seen": seen.routes(), "routes_rule": want, "k1_shapes": sorted(shapes),
                   "k4_shapes": sorted((M, K, N, str(dt)) for M, K, N, dt in k4_shapes),
                   "peak_gib": peak, "decode_weight_bytes": decode_weight_bytes(model.llm),
                   "tick_trace": tick, **probe.summary(), "decode_step": held, "vs_generate": vs,
                   "vs_bf16_tokens": token_agreement(probe.tokens, bf16_tokens)}
            routes[mode] = row
            checks += [(not unchecked and shapes, f"{label}: K1 took shapes phase 3 does not hold: "
                                                  f"{unchecked}"),
                       (not unheld, f"{label}: generate alone gave K4 shapes phase 4c does not "
                                    f"hold: {unheld}"),
                       (row["batched_steps"] > 0, f"{label}: no tick served two slots"),
                       (len(replies) == MUVLA_SLOTS, f"{label}: {len(replies)} replies")]
            print(f"  {label}: {row['requests']} requests p50 {row['p50_ms']:.1f} ms, p90 "
                  f"{row['p90_ms']:.1f} ms; ms a full tick {row['ms_a_tick_full']}; routes "
                  f"{seen.routes()} (rule {want}); launches {launches}; peak {peak:.2f} GiB; decode "
                  f"weights {row['decode_weight_bytes'] / 2 ** 30:.3f} GiB a step; traced tick "
                  f"{tick['tick_ms']:.1f} ms, idle {tick['idle_share']:.1%}, device by part "
                  f"{ {k: round(v, 3) for k, v in tick['device_ms_by_part'].items()} }; tokens vs "
                  f"bf16 {row['vs_bf16_tokens']}")
            free_memory()
    finally:
        qm.W8A8_MIN_ROWS = None  # a process-wide global: no later int8 route runs under it
    failures.extend(msg for ok, msg in checks if not ok)
    del model
    free_memory()
    return {"prompt_tokens": MUVLA_PROMPT_TOKENS, "routes": routes}


# ---------------------------------------------------------------------------
# Phase 15: pi0.5, DM0 and DM0-Prog served and trained, hybrid CogACT, the harness
# ---------------------------------------------------------------------------

# K1's calls of pi0.5 and DM0 beside pi0's (PI0_CASES).  pi0.5 keeps pi0's
# prefix (its served 1 x 832 is d256_served_prefix) and runs a 50-row suffix,
# no state token, in one group after the bidirectional prefix: 8/1 heads of
# 256.  DM0 (Qwen3-1.7B and the Qwen3-0.6B expert: 16/8 heads of 128,
# qk-norm in both streams) has a causal prefix, a group a token; its 100
# text ids (all valid: DM0's tokenizer pads with a non-zero id) are served
# in the 128-token bucket (896 = 768 + 128, the last 28 masked); its 50-row
# suffix and DM0-Prog's 51 (the progress token, then the actions) are one
# group after the prefix.  Training (15c) runs the LIBERO twins' joint rows:
# pi0.5's 200-token text and 10-action chunk (978 tokens), DM0's 100 and 50
# (918).  FLOW_CASES: (result key, variant, B, text slots, valid text, part).
FLOW_VIEWS = 3 * 256
FLOW_HEADS = {"pi05": (8, 1, 256), "dm0": (16, 8, 128), "dm0_prog": (16, 8, 128)}
FLOW_SUFFIX = {"pi05": 50, "dm0": 50, "dm0_prog": 51}
FLOW_TRAIN = {"pi05": (200, 10), "dm0": (100, 50)}  # (text, chunk) of the LIBERO twins' rows
FLOW_CASES = [
    ("pi05_served_suffix", "pi05", 1, 64, 22, "suffix"),
    ("pi05_train", "pi05", PI0_TRAIN_MICRO, 200, 200, "train"),
    ("dm0_served_prefix", "dm0", 1, 128, 100, "prefix"),
    ("dm0_served_suffix", "dm0", 1, 128, 100, "suffix"),
    ("dm0_prog_served_suffix", "dm0_prog", 1, 128, 100, "suffix"),
    ("dm0_train", "dm0", PI0_TRAIN_MICRO, 100, 100, "train")]


def flow_k1_shape(variant: str, B: int, text: int, n_valid: int, part: str,
                  views: int = FLOW_VIEWS) -> tuple:
    """(B, query rows, key rows) of a FLOW_CASES call over ``views`` image tokens."""
    prefix = views + text
    suffix = FLOW_TRAIN[variant][1] if part == "train" else FLOW_SUFFIX[variant]
    S = prefix + (0 if part == "prefix" else suffix)
    return B, prefix if part == "prefix" else suffix if part == "suffix" else S, S


# the K1 shapes phase 3b holds for each served variant (15a and 15b fail on another)
K1_FLOW_SERVED = {v: {flow_k1_shape(*c[1:]) for c in FLOW_CASES if c[1] == v and c[5] != "train"}
                  for v in FLOW_HEADS}
K1_FLOW_SERVED["pi05"].add((1, PI0_VIEWS + 64, PI0_VIEWS + 64))  # pi0's d256_served_prefix


def flow_attn_inputs(variant: str, B: int, text: int, n_valid: int, part: str, gen,
                     views: int = FLOW_VIEWS, device="cuda"):
    """(name, q, k, v, (q_grp, kv_grp, kv_valid), None) of a FLOW_CASES call:
    the prefix of ``views`` image tokens and ``text`` slots (the first
    ``n_valid`` valid), bidirectional for pi0.5, causal for DM0; the suffix
    against the cached prefix; or the training rows, prefix then suffix."""
    Hq, Hkv, D = FLOW_HEADS[variant]
    _, Sq, S = flow_k1_shape(variant, B, text, n_valid, part, views)
    prefix = views + text
    dev = torch.device(device)
    valid = torch.ones(B, S, dtype=torch.int32, device=dev)
    valid[:, views + n_valid: prefix] = 0
    ar = torch.zeros(B, S, dtype=torch.int32, device=dev)
    if variant != "pi05":
        ar[:, :prefix] = 1  # a group a prefix token
    if S > prefix:
        ar[:, prefix] = 1  # the suffix: one group after the prefix
    grp = torch.cumsum(ar, 1, dtype=torch.int32)
    q = torch.randn(B, Sq, Hq, D, generator=gen, device=dev).bfloat16()
    k, v = (torch.randn(B, S, Hkv, D, generator=gen, device=dev).bfloat16() for _ in range(2))
    name = f"{variant} {part} B={B} Sq={Sq} Skv={S} H={Hq}/{Hkv} D={D}"
    return name, q, k, v, (grp[:, S - Sq:].contiguous(), grp, valid), None


FLOW_REQUESTS = 3  # 15a's and 15b's timed single requests, after one not timed
DM0_PROG_TOL = 0.05  # |end-progress, kernel path - plain path|, stated before the first run


def flow_norms(action_dim: int, seed: int) -> dict:
    """Seeded quantile statistics, as pi0.5's and DM0's servers read them:
    the q01 and q99 of 7 env action dims and of the state padded to
    ``action_dim``, under the keys ServingStats takes ("min", "max")."""
    rng = np.random.default_rng(seed)

    def quantiles(n):
        lo = rng.uniform(-1.5, -0.2, n)
        return {"min": lo.tolist(), "max": (lo + rng.uniform(0.5, 3.0, n)).tolist()}

    return {"action": quantiles(7), "state": quantiles(action_dim)}


def redraw_adarms_(model, gen) -> None:
    """pi0.5's adaRMS projections (the expert norms' ``dense``) are zero at
    init, which would leave the time condition out of every chunk: redrawn,
    N(0, 0.02), so that the checks see it."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".dense." in name:
                p.normal_(0.0, 0.02, generator=gen)


@contextlib.contextmanager
def adarms_conditions(dtypes: list):
    """Appends the dtype of every adaRMS condition embed_suffix makes (pi0.5's
    time, which the JAX package keeps in fp32) to ``dtypes`` while inside."""
    from dexbotic_tpu_torch.models import flow_vla as fv

    call = fv.embed_suffix

    def recorded(*args, **kw):
        out = call(*args, **kw)
        if out[3] is not None:
            dtypes.append(out[3].dtype)
        return out

    fv.embed_suffix = recorded
    try:
        yield dtypes
    finally:
        fv.embed_suffix = call


def phase_flow_serve(failures: list, variant: str) -> dict:
    """Phase 15a (pi0.5: ``Pi05Exp``, SigLIP so400m/224 + Gemma-2B + the
    Gemma-300M adaRMS expert) or 15b (DM0: ``DM0Exp``, SigLIP so400m/224 +
    Qwen3-1.7B + the Qwen3-0.6B expert) at full width, bf16 weights and fp32
    activations, served through FlowVLAServer with quantile statistics:
    FLOW_REQUESTS + 1 requests of 3 views and a state and one of 1 view,
    with every kernel's launches (K1: layers x (1 + Euler steps) a request),
    K1's shapes (K1_FLOW_SERVED) and the plain CUDA attention calls read
    around them, and pi0.5's adaRMS condition in fp32; the kernel path
    against the plain path on one request's inputs and injected noise (chunk
    and integrated-velocity cosine >= 0.99); p50 / p90 and the device call
    by part (pi0.5's adaRMS projections redrawn: redraw_adarms_).  DM0 then
    serves DM0-Prog (:func:`dm0_prog_call`)."""
    from dexbotic_tpu_torch.data.image_processing import preprocess_images_batch
    from dexbotic_tpu_torch.exp.pi0_exp import DM0Exp, Pi05Exp
    from dexbotic_tpu_torch.exp.serve import FlowVLAServer, _decode_frames
    from dexbotic_tpu_torch.models import flow_vla as fv
    from dexbotic_tpu_torch.ops.attention import flash_attention
    from script.profile_pi0_torch import part_calls, split_parts, wall_ms

    label = {"pi05": "15a", "dm0": "15b"}[variant]
    exp = {"pi05": Pi05Exp, "dm0": DM0Exp}[variant](device="cuda")
    t0 = time.perf_counter()
    cfg, model, _ = exp.load_for_inference()
    redraw_adarms_(model, torch.Generator(device="cuda").manual_seed(149))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    m = exp.model
    print(f"phase {label}: {exp.exp_name} ({m.vit_preset} + {m.llm_preset} + {m.expert_preset}, "
          f"{n_params / 1e9:.3f}B params, bf16 weights, fp32 activations, built in {build_s:.1f} s) "
          f"served through /process_frame with quantile statistics")
    D = cfg.action_dim
    norms = flow_norms(D, seed=150)
    rng = np.random.default_rng(151)
    state = json.dumps(rng.normal(0, 0.5, 8).round(4).tolist())  # an 8-dof robot's state
    views = [_frame_png(seed) for seed in range(3)]
    server = FlowVLAServer(exp, cfg, model, exp.tokenizer.build_tokenizer(), norms,
                           host="127.0.0.1", port=0)
    row = server._prompt_ids(PROMPT)
    text, n_valid = -(-len(row) // 64) * 64, int((row != 0).sum())
    held = {(c[3], c[4]) for c in FLOW_CASES if c[1] == variant and c[5] != "train"}
    if not server.stats.use_quantiles or (text, n_valid) not in held:
        failures.append(f"{label}: quantiles {server.stats.use_quantiles}; the request's text is "
                        f"{n_valid} valid ids in {text} slots, phase 3b holds {held}")
    httpd = server.serve_background()
    port = httpd.server_address[1]
    per_call = cfg.llm.num_layers * (1 + cfg.num_flow_steps)
    shapes, conds = set(), []
    torch.cuda.reset_peak_memory_stats()
    try:
        with k1_calls(shapes), adarms_conditions(conds):
            _zero_counts()
            singles, latencies = [], []
            for _ in range(FLOW_REQUESTS + 1):
                out, dt = _post(port, PROMPT, views, states=state)
                singles.append(out)
                latencies.append(dt)
            one_view, _ = _post(port, PROMPT, views[:1], states=state)
            launches = _launch_counts()
    finally:
        httpd.shutdown()
        httpd.server_close()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_req = FLOW_REQUESTS + 2
    print(f"  prompt {n_valid} valid ids in {text} slots; launches during {n_req} requests: "
          f"{launches} (K1 expected {n_req} x {cfg.llm.num_layers} x (1 + {cfg.num_flow_steps}) "
          f"= {n_req * per_call}); K1 shapes {sorted(shapes)}; adaRMS conditions "
          f"{sorted({str(d) for d in conds})}")
    outs = singles + [one_view]
    checks = [(all(o.shape == (cfg.chunk_size, 7) for o in outs),
               f"{label}: response shapes {sorted({o.shape for o in outs})}"),
              (all(np.isfinite(o).all() for o in outs), f"{label}: a non-finite action"),
              (launches["flash_fwd"] == n_req * per_call,
               f"{label}: K1 launched {launches['flash_fwd']} times, expected {n_req * per_call}"),
              (launches["plain_cuda_calls"] == launches["flash_bwd"] == launches["dit_sample"]
               == launches["quant_matmul"] == 0, f"{label}: launches {launches}"),
              (shapes and shapes <= K1_FLOW_SERVED[variant],
               f"{label}: K1 shapes {sorted(shapes - K1_FLOW_SERVED[variant])} not held by 3b"),
              (set(conds) == ({torch.float32} if cfg.adarms else set()),
               f"{label}: adaRMS conditions in {set(conds)}")]
    failures.extend(msg for ok, msg in checks if not ok)
    lat = sorted(x * 1e3 for x in latencies[1:])
    p50, p90 = statistics.median(lat), float(np.percentile(lat, 90))
    print(f"  request latency ms over {len(lat)} after the first ({latencies[0] * 1e3:.1f}): "
          f"p50 {p50:.1f}, p90 {p90:.1f}; peak memory allocated {peak:.2f} GiB")

    # one request's inputs by hand: the kernel path, the plain path, the parts
    ids = np.zeros((1, text), np.int32)
    ids[0, : len(row)] = row
    ids_t = torch.from_numpy(ids).cuda()
    text_mask = (ids_t != 0).to(torch.int32)
    frames, order = _decode_frames(views)
    imgs = torch.from_numpy(preprocess_images_batch(
        frames, exp.data.build_image_processor(), channel_order=order))[None].cuda()
    masks = torch.ones((1, 3), dtype=torch.int32, device="cuda")
    states = torch.from_numpy(server.stats.normalize(
        "state", server._parse_state(state, D)[None])).cuda()
    noise = torch.randn((1, cfg.chunk_size, D), generator=torch.Generator(
        device="cuda").manual_seed(152), device="cuda")
    args = (ids_t, text_mask, imgs, masks, states)
    plain_cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, attn_impl="xla"),
                                    expert=dataclasses.replace(cfg.expert, attn_impl="xla"))
    a = fv.flow_vla_inference_action(model, cfg, *args, noise=noise)
    n0 = flash_attention.launches
    b = fv.flow_vla_inference_action(model, plain_cfg, *args, noise=noise)
    cos = _cosine(a.flatten(), b.flatten())
    vcos = _cosine((a - noise).flatten(), (b - noise).flatten())
    print(f"  kernel path (K1 in bf16) vs fp32 plain path: max abs diff "
          f"{(a - b).abs().max().item():.5g}, chunk cosine {cos:.6f}, integrated-velocity "
          f"cosine {vcos:.6f}, |chunk| max {b.abs().max().item():.4g}")
    if flash_attention.launches != n0:
        failures.append(f"{label}: the plain path launched K1")
    if not (cos >= 0.99 and vcos >= 0.99):
        failures.append(f"{label}: chunk cosine {cos} / velocity cosine {vcos} < 0.99")
    calls = part_calls(model, cfg, *args, noise)
    parts = {f"{part}_ms": ms for part, (ms,) in
             split_parts({name: (wall_ms(fn, reps=PART_REPS),)
                          for name, fn in calls.items()}).items()}
    print(f"  device path (CUDA-synchronised wall clock, medians of {PART_REPS}): ViT + projector (and the "
          f"text embedding) {parts['vit_projector_ms']:.2f} ms, prefill {parts['prefill_ms']:.2f} ms "
          f"({cfg.llm.num_layers} layers), {cfg.num_flow_steps} Euler steps "
          f"{parts['euler_steps_ms']:.2f} ms, whole call {parts['device_call_ms']:.2f} ms")
    result = {"params": n_params, "prompt": [n_valid, text], "launches": launches,
              "launches_per_request": per_call, "k1_shapes": sorted(shapes), "p50_ms": p50,
              "p90_ms": p90, "peak_gib": peak, "cosine": cos, "velocity_cosine": vcos, **parts}
    if variant == "dm0":
        result["dm0_prog"] = dm0_prog_call(failures, model, cfg, args, noise)
    del server, model, a, b, calls
    free_memory()
    return result


def dm0_prog_call(failures: list, model, cfg, args: tuple, noise) -> dict:
    """15b's DM0-Prog: ``dm0_prog_config`` over DM0's backbone pair, its two
    progress projections (1 -> the expert's width -> 1) drawn from a seeded
    generator into DM0's model in the serving dtype (neither package has a
    DM0-Prog exp); one ``flow_vla_inference_action(progress=...)`` on the
    kernel path, with its K1 launches and shapes, against the plain path on
    the same noise and progress input: chunk cosine >= 0.99 and the
    end-progress within DM0_PROG_TOL."""
    from dexbotic_tpu_torch.models import flow_vla as fv
    from dexbotic_tpu_torch.nn.core import Linear, cast_like_jax_, torch_linear_init_

    pcfg = fv.dm0_prog_config(cfg.llm, cfg.expert, cfg.vit, projector_type=cfg.projector_type,
                              action_dim=cfg.action_dim, chunk_size=cfg.chunk_size,
                              num_flow_steps=cfg.num_flow_steps)
    gen = torch.Generator(device="cuda").manual_seed(153)
    eh = cfg.expert.hidden_size
    with torch.no_grad():
        for name, (i, o) in (("progress_in_proj", (1, eh)), ("progress_out_proj", (eh, 1))):
            lin = Linear(i, o, device="cuda")
            torch_linear_init_(lin, gen)
            setattr(model, name, cast_like_jax_(lin, torch.bfloat16).requires_grad_(False))
    plain = dataclasses.replace(pcfg, llm=dataclasses.replace(pcfg.llm, attn_impl="xla"),
                                expert=dataclasses.replace(pcfg.expert, attn_impl="xla"))
    progress = torch.full((1, 1, 1), 0.35, device="cuda")
    shapes: set = set()
    _zero_counts()
    with k1_calls(shapes):
        a, pa = fv.flow_vla_inference_action(model, pcfg, *args, progress=progress, noise=noise)
    launches = _launch_counts()
    b, pb = fv.flow_vla_inference_action(model, plain, *args, progress=progress, noise=noise)
    plain_launches = _launch_counts()["flash_fwd"] - launches["flash_fwd"]
    cos = _cosine(a.flatten(), b.flatten())
    dprog = (pa - pb).abs().max().item()
    want = cfg.llm.num_layers * (1 + cfg.num_flow_steps)
    print(f"  DM0-Prog (progress input {progress.item()}): K1 {launches['flash_fwd']} launches "
          f"(expected {want}), shapes {sorted(shapes)}; kernel vs plain path: chunk cosine "
          f"{cos:.6f}, end-progress {pa.item():.6f} vs {pb.item():.6f} (|diff| {dprog:.3g}, "
          f"tolerance {DM0_PROG_TOL})")
    checks = [(launches["flash_fwd"] == want and plain_launches == 0
               and launches["plain_cuda_calls"] == 0,
               f"15b DM0-Prog: K1 {launches['flash_fwd']} (want {want}), plain path K1 "
               f"{plain_launches}, plain calls {launches['plain_cuda_calls']}"),
              (shapes and shapes <= K1_FLOW_SERVED["dm0"] | K1_FLOW_SERVED["dm0_prog"],
               f"15b DM0-Prog: K1 shapes {sorted(shapes)} not held by 3b"),
              (cos >= 0.99 and dprog <= DM0_PROG_TOL and bool(torch.isfinite(pa).all()),
               f"15b DM0-Prog: chunk cosine {cos}, end-progress |diff| {dprog} "
               f"(want >= 0.99, <= {DM0_PROG_TOL})")]
    failures.extend(msg for ok, msg in checks if not ok)
    del model.progress_in_proj, model.progress_out_proj
    return {"launches": launches, "k1_shapes": sorted(shapes), "cosine": cos,
            "progress": [pa.item(), pb.item()], "progress_abs_diff": dprog}


def backward_reading(m, loss_fn, watched: dict, trainable=None) -> tuple[dict, dict]:
    """One backward pass of ``loss_fn(m) -> (loss, metrics)``, only the
    parameters in ``trainable`` (all if None) taking gradients: (the loss,
    the metrics, grad_norm, the pass's K1/K3 launches and the seconds of its
    forward and backward, CUDA-synchronised; each ``watched`` group's
    gradients, the names under its prefixes, flattened in fp32); the
    gradients are dropped after."""
    from dexbotic_tpu_torch.exp.optim import global_norm
    from dexbotic_tpu_torch.ops.attention import flash_attention, flash_attention_bwd

    for name, p in m.named_parameters():
        p.requires_grad_(trainable is None or name in trainable)
    n0 = (flash_attention.launches, flash_attention_bwd.launches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.enable_grad():
        loss, metrics = loss_fn(m)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    named = [(name, p.grad) for name, p in m.named_parameters() if p.grad is not None]
    out = {**{k: float(v.detach()) for k, v in metrics.items()}, "loss": float(loss.detach()),
           "grad_norm": float(global_norm([g for _, g in named])),
           "launches": (flash_attention.launches - n0[0], flash_attention_bwd.launches - n0[1]),
           "forward_s": t1 - t0, "backward_s": t2 - t1}
    grads = {k: torch.cat([g.float().flatten() for name, g in named if name.startswith(prefixes)])
             for k, prefixes in watched.items()}
    for p in m.parameters():
        p.grad = None
    m.requires_grad_(False)
    return out, grads


def step_paths(model, cfg, plain, loss_fn, watched: dict, build, label: str,
               trainable=None) -> dict:
    """10a's readings of one step of the fp32 ``model``: the fp32 witness
    (``plain``, the plain attention in fp32), the plain path (its plain
    version on q, k, v rounded to bf16: decoder_plain_on_bf16), the kernel
    path (``cfg``: K1, K3) and bf16 weights (a copy ``build`` makes under
    the Trainer's rule, trainer_rule_copy, on the plain attention, freed
    after); each a :func:`backward_reading` of ``loss_fn(model, config)``;
    "rule" holds the copy's reading."""
    def read(m, c):
        return backward_reading(m, lambda m: loss_fn(m, c), watched, trainable)

    paths = {"fp32_witness": read(model, plain)}
    with decoder_plain_on_bf16():
        paths["plain"] = read(model, plain)
    paths["kernel"] = read(model, cfg)
    bf, paths["rule"] = trainer_rule_copy(build, plain, model, label)
    paths["bf16"] = read(bf, plain)
    del bf
    free_memory()
    return paths


FLOW_TRAIN_STEPS = 2  # 15c's timed steps of each twin at 4 x 4


def flow_train_exp(variant: str, dataset: str, stats: str, out: str, micro: int, accum: int,
                   steps: int):
    """The LIBERO twin of ``variant`` (playground/benchmarks/libero/
    libero_pi05.py, libero_dm0.py) at full width and depth with remat, on
    ``dataset`` and the pi0-format ``stats``, with the two changes it needs
    to train at all, in either package (ROADMAP Queue 3): image masks on (its
    fresh action config drops them, while its data_keys ask for them), and
    the actions padded to the model's action_dim (DM0's 7, not
    Pi0ActionConfig's 32); ``micro`` x ``accum`` rows a step, the
    checkpoint without the moments."""
    from dexbotic_tpu_torch.playground.benchmarks.libero.libero_dm0 import LiberoDM0Exp
    from dexbotic_tpu_torch.playground.benchmarks.libero.libero_pi05 import LiberoPi05Exp

    exp = {"pi05": LiberoPi05Exp, "dm0": LiberoDM0Exp}[variant](device="cuda")
    exp.data = dataclasses.replace(exp.data, dataset_name=dataset)
    exp.action = dataclasses.replace(exp.action, statistic_mapping=stats,
                                     load_multimodal_masks=True, action_ndim=exp.model.action_dim)
    exp.trainer = dataclasses.replace(exp.trainer, output_dir=out, max_steps=steps,
                                      per_device_batch_size=micro,
                                      gradient_accumulation_steps=accum, logging_steps=1,
                                      save_steps=steps, resume=False, save_optimizer=False)
    return exp


def phase_flow_train_compare(failures: list, variant: str, dataset: str, stats: str) -> dict:
    """15c's first half: one step of the twin (micro-batch PI0_TRAIN_MICRO:
    four samples spread over the suite) in fp32, full fine-tune, the flow
    noise and times injected: the kernel path (K1, K3 on q, k, v rounded to
    bf16), the plain path (their plain version on the same rounded q, k, v:
    decoder_plain_on_bf16) and bf16 weights (a copy under the Trainer's rule
    on the plain attention, a reading), each against an fp32 witness (the plain
    attention in fp32): loss, grad_norm and the gradient 1-cosine of the
    LLM's and the expert's first layers (each gradient there has passed
    through every layer's attention backward) and of the action projections;
    10a's rule (hold_step).  pi0.5's adaRMS projections are redrawn."""
    from dexbotic_tpu_torch.data.collator import Collator
    from dexbotic_tpu_torch.models import flow_vla as fv

    B = PI0_TRAIN_MICRO
    exp = flow_train_exp(variant, dataset, stats, f"out_{variant}_compare", B, 1, 1)
    tok = exp.tokenizer.build_tokenizer()
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    cfg, model, _ = exp.build_model(tok)
    redraw_adarms_(model, torch.Generator(device="cuda").manual_seed(157))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"phase 15c: one {exp.exp_name} training step ({n_params / 1e9:.3f}B parameters, fp32, "
          f"full fine-tune, micro-batch {B}): kernel path vs plain path (both on bf16 q, k, v) vs "
          f"fp32 witness; bf16 weights as a reading")
    ds = exp.data.build_data(exp.build_tokenization(tok), exp.action.build_action_process_func())
    seed_rows_(ds, exp.trainer.seed)
    host = Collator(pad_token_id=tok.pad_token_id, max_length=exp.tokenizer.model_max_length)(
        [ds[i * (len(ds) - 1) // (B - 1)] for i in range(B)])
    batch = {k: torch.as_tensor(v).cuda() for k, v in host.items()}
    text, chunk = FLOW_TRAIN[variant]
    valid = batch["attention_mask"].sum(1).tolist()
    print(f"  rows: images {tuple(batch['images'].shape)}, text {valid} valid of "
          f"{batch['input_ids'].shape[1]}, actions {tuple(batch['actions'].shape)}")
    if (batch["input_ids"].shape[1], min(valid), batch["actions"].shape[1]) != (text, text, chunk):
        failures.append(f"15c {variant}: rows of {batch['input_ids'].shape[1]} text slots "
                        f"({valid} valid) and {batch['actions'].shape[1]} actions; phases 3b "
                        f"and 6 hold {text} valid of {text} and {chunk}")
    g = torch.Generator(device="cuda").manual_seed(154)
    noise = torch.randn((B, cfg.chunk_size, cfg.action_dim), generator=g, device="cuda")
    time_ = fv.sample_flow_time(B, g, "cuda")
    plain = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, attn_impl="xla"),
                                expert=dataclasses.replace(cfg.expert, attn_impl="xla"))
    watched = {"llm_first_layer": ("vlm.llm.layers.0.",), "expert_first_layer": ("expert.layers.0.",),
               "action_proj": ("action_in_proj.", "action_out_proj.")}
    paths = step_paths(
        model, cfg, plain,
        lambda m, c: fv.flow_vla_loss(m, c, batch, remat=True, noise=noise, time=time_),
        watched, fv.build_flow_vla, f"15c {variant}'s bf16 copy")
    (w32, g32), (wpl, gpl), (wk, gk), (wbf, gbf) = (
        paths[p] for p in ("fp32_witness", "plain", "kernel", "bf16"))
    rule = paths["rule"]
    for lab, w in (("kernel", wk), ("plain", wpl), ("bf16", wbf), ("fp32 witness", w32)):
        print(f"  {lab}: loss {w['loss']:.6g} grad_norm {w['grad_norm']:.6g}; K1/K3 launches "
              f"{w['launches']}; forward {w['forward_s']:.2f} s, backward {w['backward_s']:.2f} s")
    L = cfg.llm.num_layers
    checks = [(all(math.isfinite(wk[k]) for k in ("loss", "grad_norm")),
               f"15c {variant}: non-finite kernel-path metrics {wk}"),
              (wk["launches"][1] >= L and w32["launches"] == wpl["launches"]
               == wbf["launches"] == (0, 0),
               f"15c {variant}: K1/K3 launches kernel path {wk['launches']}, plain paths "
               f"{wpl['launches']} {w32['launches']} {wbf['launches']}")]
    witness, bounds = hold_step(f"15c {variant}", {"kernel": (wk, gk), "plain": (wpl, gpl),
                                                   "bf16": (wbf, gbf)}, (w32, g32),
                                {"loss": "rel", "grad_norm": "rel"}, checks)
    failures.extend(msg for ok, msg in checks if not ok)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  peak memory allocated {peak:.2f} GiB")
    del model, paths, g32, gpl, gk, gbf, batch
    free_memory()
    return {"params": n_params, "rows": [B, FLOW_VIEWS + text + chunk], "peak_gib": peak,
            "kernel": wk, "plain": wpl, "bf16": wbf, "fp32_witness": w32,
            "vs_fp32": witness, "bounds": bounds, **rule}


def phase_flow_train_steps(failures: list, variant: str, dataset: str, stats: str) -> dict:
    """15c's second half: FLOW_TRAIN_STEPS steps of the twin through
    ``exp.train()`` at 4 x 4 (recorded_train: each step's peak; K1-K4 and the
    plain CUDA attention calls read around the run, K1's and K3's shapes):
    K3 exactly layers x 4 a step, K1 at least twice that (remat), no plain
    call, the shapes phases 3b and 6 hold, the peak under 80 GiB."""
    micro, accum, steps = PI0_TRAIN_MICRO, 4, FLOW_TRAIN_STEPS
    out = f"out_{variant}_train"
    exp = flow_train_exp(variant, dataset, stats, out, micro, accum, steps)
    print(f"phase 15c: {steps} {exp.exp_name} training steps through exp.train() "
          f"(micro-batch {micro}, accumulation {accum}, remat, full fine-tune)")
    L = exp.model.build_config().llm.num_layers
    run = recorded_train(exp, out)
    log, seen, rows, launches, wall = (run[k] for k in ("log", "seen", "rows", "launches", "wall"))
    for r, s_ in zip(rows, seen):
        print(f"  step {r['step']}: loss {r['loss']:.6g} grad_norm {r['grad_norm']:.6g} step time "
              f"{1 / r['steps_per_sec']:.4f} s; peak {s_['peak_gib']:.2f} GiB")
    step_s = statistics.median(1 / r["steps_per_sec"] for r in rows[1:])
    peak = max(s_["peak_gib"] for s_ in seen) if seen else float("nan")
    S = FLOW_VIEWS + sum(FLOW_TRAIN[variant])
    unchecked = sorted((run["k1_shapes"] | run["k3_shapes"]) - {(micro, S, S)})
    n_bwd = L * accum * steps
    print(f"  train() wall {wall:.1f} s; step {step_s:.4f} s (median of steps 2-{steps}), "
          f"{micro * accum / step_s:.3f} samples/s; peak {peak:.2f} GiB; launches {launches} "
          f"({launches['flash_fwd'] // steps} K1 and {launches['flash_bwd'] // steps} K3 a step); "
          f"K1 shapes {sorted(run['k1_shapes'])}, K3 shapes {sorted(run['k3_shapes'])}")
    checks = [(log.get("step") == steps and len(rows) == steps == len(seen),
               f"15c {variant}: ran {len(rows)} of {steps} steps"),
              (all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in rows),
               f"15c {variant}: non-finite loss or grad_norm"),
              (launches["flash_bwd"] == n_bwd and launches["flash_fwd"] >= 2 * n_bwd
               and launches["plain_cuda_calls"] == launches["dit_sample"]
               == launches["quant_matmul"] == 0,
               f"15c {variant}: launches {launches}, want K3 {n_bwd}, K1 >= {2 * n_bwd}"),
              (not unchecked, f"15c {variant}: K1/K3 shapes {unchecked} not held by 3b and 6"),
              (peak < 80, f"15c {variant}: peak {peak:.2f} GiB >= 80")]
    failures.extend(msg for ok, msg in checks if not ok)
    return {"launches": launches, "launches_per_step": {k: v // steps for k, v in launches.items()},
            "step_s": step_s, "samples_per_s": micro * accum / step_s, "peak_gib": peak,
            "train_wall_s": wall, "losses": [r["loss"] for r in rows]}


def phase_flow_train(failures: list) -> dict:
    """Phase 15c in a temp dir (a 3-view suite of 60-frame episodes, each
    twin's statistics, checkpoints), removed after: pi0.5, then DM0, each
    model freed before the next."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp, working_dir(tmp):
        dataset = write_suite(os.path.join(tmp, "suite"), views=3, name="flow", frames=60,
                              episodes=2)
        for variant in ("pi05", "dm0"):
            dim = flow_train_exp(variant, dataset, "", "", 1, 1, 1).model.action_dim
            stats = write_pi0_stats(os.path.join(tmp, f"{variant}_norm_stats.json"), dim=dim)
            compare = phase_flow_train_compare(failures, variant, dataset, stats)
            free_memory()
            out[variant] = {"compare": compare,
                            **phase_flow_train_steps(failures, variant, dataset, stats)}
            free_memory()
    return out


# 15d: HybridCogActExp's mixed batch, a robot row of the suite of phase 7 and
# a VQA row (write_vqa_suite), each padded to the recipe's TRAIN_SEQ_LEN;
# HYBRID_ROWS are their valid tokens (the robot row carries no action text:
# the hybrid action config adds no answer; the VQA row is its prompt and
# answer).  Phases 3 and 6 hold K1 and K3 at the batch's rows
# (hybrid_attn_inputs).
HYBRID_ROWS = (858, 241)


def hybrid_attn_inputs(gen):
    """(name, q, k, v, (q_grp, kv_grp, kv_valid), None) of 15d's decoder call:
    the two rows of HYBRID_ROWS valid tokens, padded to TRAIN_SEQ_LEN, causal,
    LLaMA-2's 32 heads of 128."""
    _, q, k, v, ints, seg = oft_attn_inputs(2, HYBRID_ROWS, TRAIN_SEQ_LEN, 0, False, gen)
    return (f"hybrid training B=2 S={TRAIN_SEQ_LEN} ({HYBRID_ROWS} valid) H=32/32 D=128",
            q, k, v, ints, seg)


def write_vqa_suite(root: str, name: str = "vqa", episodes: int = 2, frames: int = 4) -> str:
    """A synthetic VQA suite (text rows: a 480x640 frame, a question and its
    answer, no state), as tests/test_hybrid.py's 'general' data; returns its name."""
    from PIL import Image

    from dexbotic_tpu_torch.data.registry import register_dataset

    rng = np.random.default_rng(7)
    os.makedirs(root, exist_ok=True)
    for e in range(episodes):
        lines = []
        for t in range(frames):
            url = f"v{e}f{t}.png"
            Image.fromarray(rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)).save(
                os.path.join(root, url))
            lines.append(json.dumps({"images_1": {"type": "image", "url": url},
                                     "prompt": "what is on the table next to the bowl?",
                                     "answer": "a red mug and a folded towel"}))
        with open(os.path.join(root, f"v{e}.jsonl"), "w") as f:
            f.write("\n".join(lines))
    register_dataset({name: {"data_path_prefix": root, "annotations": root, "frequency": 1}},
                     prefix="general", meta_data={"non_delta_mask": [6], "periodic_mask": None,
                                                  "periodic_range": None})
    return f"general_{name}"


def hybrid_exp(dataset: str, out: str, micro: int):
    """HybridCogActExp at CogACT-7B's widths (CLIP-L/336 frames) with phase 7's
    optimizer (a frozen LLM and vision tower), rows of TRAIN_SEQ_LEN."""
    from dexbotic_tpu_torch.exp.cogact_exp import CogActModelConfig
    from dexbotic_tpu_torch.exp.hybrid_cogact_exp import HybridCogActExp
    from dexbotic_tpu_torch.exp.optim import OptimizerConfig
    from dexbotic_tpu_torch.exp.trainer import TrainerConfig

    base = HybridCogActExp()
    return HybridCogActExp(
        model=CogActModelConfig(),
        data=dataclasses.replace(base.data, dataset_name=dataset, image_processor="clip_336",
                                 aug_policy="v1"),
        trainer=TrainerConfig(output_dir=out, max_steps=1, per_device_batch_size=micro,
                              logging_steps=1, save_steps=1, bf16=True,
                              gradient_checkpointing=True, resume=False),
        optimizer=OptimizerConfig(learning_rate=2e-5, max_grad_norm=1.0, freeze_llm=True,
                                  freeze_mm_vision=True),
        device="cuda")


def hybrid_batch(exp, tok) -> dict:
    """The first robot row and the first text row of the mixed suite, collated
    to TRAIN_SEQ_LEN, their draws seeded (seed_rows_)."""
    from dexbotic_tpu_torch.data.collator import Collator

    ds = exp.data.build_data(exp.build_tokenization(tok), exp.action.build_action_process_func())
    seed_rows_(ds, 3)
    robot = text = None
    for i in range(len(ds)):
        item = ds[i]
        if robot is None and np.any(item["has_action"]):
            robot = item
        if text is None and np.any(item["has_text"]):
            text = item
        if robot is not None and text is not None:
            break
    return Collator(pad_token_id=tok.pad_token_id, max_length=exp.tokenizer.model_max_length)(
        [robot, text])


def phase_hybrid(failures: list) -> dict:
    """Phase 15d: one HybridCogActExp step at full width on a mixed batch (a
    robot row, a text row), fp32, the LLM and the tower frozen, the diffusion
    draws injected: the text loss (causal LM over the 32000 logits of every
    row) and the action loss, the kernel path (K1, K3 on bf16 q, k, v: the
    text loss's gradient reaches the projector through the frozen LLM's K3),
    the plain path on the same rounded q, k, v and bf16 weights (a reading)
    against an fp32 witness: 10a's rule on the loss, grad_norm and the
    gradient 1-cosine of the projector, the DiT and lm_head (which
    ``freeze_llm`` leaves trainable); each path's text and action loss."""
    from dexbotic_tpu_torch.exp.optim import is_frozen
    from dexbotic_tpu_torch.models.cogact import build_cogact, cogact_loss

    B = 2
    with tempfile.TemporaryDirectory() as tmp, working_dir(tmp):
        robot = write_suite(os.path.join(tmp, "suite"), name="hyb")
        vqa = write_vqa_suite(os.path.join(tmp, "vqa"))
        exp = hybrid_exp(f"{robot}+{vqa}", "out_hybrid", B)
        exp._auto_compute_norm_stats()
        tok = exp.tokenizer.build_tokenizer()
        host = hybrid_batch(exp, tok)
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    cfg, model, _ = exp.build_model(tok)
    redraw_final_(model.action_head, torch.Generator(device="cuda").manual_seed(155))
    n_params = sum(p.numel() for p in model.parameters())
    batch = {k: torch.as_tensor(v).cuda() for k, v in host.items()}
    rows = tuple(batch["attention_mask"].sum(1).tolist())
    flags = (batch["has_action"].reshape(-1).tolist(), batch["has_text"].reshape(-1).tolist())
    print(f"phase 15d: one HybridCogActExp step ({n_params / 1e9:.3f}B parameters, fp32, LLM and "
          f"tower frozen) on a mixed batch: has_action {flags[0]}, has_text {flags[1]}, "
          f"{rows} valid tokens of {batch['input_ids'].shape[1]}; kernel path vs plain path "
          f"(both on bf16 q, k, v) vs fp32 witness; bf16 weights as a reading")
    checks = [(flags == ([1, 0], [0, 1]), f"15d: has_action / has_text {flags}"),
              ((rows, batch["input_ids"].shape[1]) == (HYBRID_ROWS, TRAIN_SEQ_LEN),
               f"15d: rows of {rows} tokens padded to {batch['input_ids'].shape[1]}; phases 3 "
               f"and 6 hold {HYBRID_ROWS} of {TRAIN_SEQ_LEN}")]
    g = torch.Generator(device="cuda").manual_seed(156)
    n = cfg.repeated_diffusion_steps * B
    t = torch.randint(0, cfg.diffusion_steps, (n,), generator=g, device="cuda")
    noise = torch.randn((n, cfg.chunk_size, cfg.action_dim), generator=g, device="cuda")
    plain = plain_config(cfg)
    watched = {"projector": ("vlm.projector.",), "dit": ("action_head.",),
               "lm_head": ("vlm.llm.lm_head.",)}
    trainable = {n for n, _ in model.named_parameters() if not is_frozen(n, exp.optimizer)}
    shapes: set = set()
    with k1_calls(shapes), k1_calls(shapes, "_flash_bwd_cuda"):  # the kernel path's alone
        paths = step_paths(
            model, cfg, plain, lambda m, c: cogact_loss(m, c, batch, remat=True, with_text_loss=True,
                                                        diffusion_t=t, diffusion_noise=noise),
            watched, build_cogact, "15d's bf16 copy", trainable)
    (w32, g32), (wpl, gpl), (wk, gk), (wbf, gbf) = (
        paths[p] for p in ("fp32_witness", "plain", "kernel", "bf16"))
    rule = paths["rule"]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for lab, w in (("kernel", wk), ("plain", wpl), ("bf16", wbf), ("fp32 witness", w32)):
        print(f"  {lab}: loss {w['loss']:.6g} = text {w['text_loss']:.6g} + action "
              f"{w['action_loss']:.6g}; grad_norm {w['grad_norm']:.6g}; K1/K3 launches "
              f"{w['launches']}; forward {w['forward_s']:.2f} s, backward {w['backward_s']:.2f} s")
    held = {oft_k1_shape(B, HYBRID_ROWS, TRAIN_SEQ_LEN, 0, False)}
    L = cfg.vlm.llm.num_layers
    paths = (wk, wpl, wbf, w32)
    checks += [(all(math.isfinite(w[k]) and w[k] > 0 for w in paths
                    for k in ("text_loss", "action_loss")),
                f"15d: text / action losses {[(w['text_loss'], w['action_loss']) for w in paths]}"),
               (wk["launches"] == (2 * L, L) and w32["launches"] == wpl["launches"]
                == wbf["launches"] == (0, 0),
                f"15d: K1/K3 launches kernel path {wk['launches']} (want {(2 * L, L)}), plain "
                f"paths {wpl['launches']} {w32['launches']} {wbf['launches']}"),
               (shapes == held, f"15d: K1/K3 shapes {sorted(shapes)}, phases 3 and 6 hold {held}"),
               (peak < 80, f"15d: peak {peak:.2f} GiB >= 80")]
    witness, bounds = hold_step("15d", {"kernel": (wk, gk), "plain": (wpl, gpl),
                                        "bf16": (wbf, gbf)}, (w32, g32),
                                {"loss": "rel", "grad_norm": "rel"}, checks)
    text_dist = {p: {k: abs(w[k] - w32[k]) / abs(w32[k]) for k in ("text_loss", "action_loss")}
                 for p, w in (("kernel", wk), ("plain", wpl), ("bf16", wbf))}
    print(f"  text and action loss, relative distance from the witness: {text_dist}; peak "
          f"memory allocated {peak:.2f} GiB")
    failures.extend(msg for ok, msg in checks if not ok)
    del model, paths, g32, gpl, gk, gbf, batch
    free_memory()
    return {"params": n_params, "rows": list(rows), "peak_gib": peak, "kernel": wk, "plain": wpl,
            "bf16": wbf, "fp32_witness": w32, "vs_fp32": witness, "bounds": bounds,
            **rule, "loss_parts_vs_fp32": text_dist, "launches": {"flash_fwd": wk["launches"][0],
                                                          "flash_bwd": wk["launches"][1]}}


# 15e: the port's harness (playground/eval_server.py) with the mock env
# against phase 5's server: HARNESS_ARGS are (tasks, episodes a task,
# max_steps, execute_steps).  The mock env's observations and outcomes
# follow the trial seed alone, so the report and the requests are the JAX
# harness's for the same arguments on the CPU (tests/test_torch_playground.py
# holds both harnesses to these values).
HARNESS_ARGS = (("task_0", "task_1"), 2, 32, 8)
HARNESS_REPORT = {"per_task": {"task_0": 0.5, "task_1": 0.5}, "average": 0.5, "episodes": 4,
                  "frames": 108}
HARNESS_REQUESTS = 14


def phase_harness(failures: list, serve: dict) -> dict:
    """Phase 15e: ``eval_server.evaluate()`` (env_type "mock") against
    phase 5's CogACT-7B behind a CogActServer, every count set to 0 just
    before and read just after: the report but the wall time must equal
    HARNESS_REPORT, the requests HARNESS_REQUESTS, and each request take
    K1 once a decoder layer and K2 once."""
    from dexbotic_tpu_torch.exp.serve import CogActServer
    from dexbotic_tpu_torch.playground.eval_server import EvalConfig, evaluate

    tasks, episodes, max_steps, execute = HARNESS_ARGS
    cfg = serve["cfg"]
    print(f"phase 15e: the success-rate harness (mock env, {len(tasks)} tasks x {episodes} "
          f"episodes, max_steps {max_steps}, execute_steps {execute}) against CogACT-7B")
    server = CogActServer(serve["exp"], cfg, serve["model"], serve["tokenizer"], serve["norms"],
                          host="127.0.0.1", port=0)
    httpd = server.serve_background()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/process_frame"
    try:
        _zero_counts()
        calls = server.host_calls
        report = evaluate(url, "mock", "libero_spatial", list(tasks), episodes, max_steps, execute,
                          EvalConfig("libero_spatial", max_steps))
        launches = _launch_counts()
        requests = server.host_calls - calls
    finally:
        httpd.shutdown()
        httpd.server_close()
    L = cfg.vlm.llm.num_layers
    print(f"  report {report}; {requests} requests; launches {launches} (per request: K1 "
          f"{launches['flash_fwd'] / max(requests, 1):g}, K2 {launches['dit_sample'] / max(requests, 1):g})")
    got = {k: v for k, v in report.items() if k != "wall_s"}
    checks = [(got == HARNESS_REPORT, f"15e: report {got}, the JAX harness's {HARNESS_REPORT}"),
              (requests == HARNESS_REQUESTS, f"15e: {requests} requests, want {HARNESS_REQUESTS}"),
              (launches["flash_fwd"] == L * requests and launches["dit_sample"] == requests
               and launches["plain_cuda_calls"] == launches["flash_bwd"] == 0,
               f"15e: launches {launches} for {requests} requests")]
    failures.extend(msg for ok, msg in checks if not ok)
    return {"report": report, "requests": requests, "launches": launches,
            "per_request": {"flash_fwd": launches["flash_fwd"] / max(requests, 1),
                            "dit_sample": launches["dit_sample"] / max(requests, 1)}}


# ---------------------------------------------------------------------------
# Phases 13e, 13f and 16: the parallel layer's last parts (parallel/ring.py,
# nn/moe.py, parallel/pipeline.py) at full width, one rank an axis (NCCL
# refuses two ranks on one card; the gloo tests hold 2 and 4 processes)
# ---------------------------------------------------------------------------

RING_SPLITS = (4, 2)  # 13f: NaVILA's 4096-token rows in 4 blocks of 1024, then 2 of 2048
# 16a: an MoE decoder at LLaMA-2-7B's layer width; 16b: a 4-layer decoder of that
# width, pipelined at ('stage', 'data') = (1, 1)
MOE_CFG = dict(vocab_size=32000, hidden_size=4096, num_layers=2, num_heads=32, num_kv_heads=32,
               head_dim=128, intermediate_size=11008, moe_num_experts=8, moe_top_k=2,
               moe_capacity_factor=2.0, has_embed=False)
MOE_ROWS, MOE_TOKENS = 2, 2048
PP_CFG = dict(MOE_CFG, num_layers=4, moe_num_experts=None, has_embed=True, tie_embeddings=False)
PP_ROWS, PP_TOKENS, PP_MICRO = 4, 2048, 4
PARALLEL_REL = 1e-5  # 13e and 16b: the CP / pipelined step against the plain one, relative
MOE_COSINE = 0.999  # 16a: kernel path against plain path, outputs and gradients


def group_of_one():
    """A process group of one over NCCL (multihost.maybe_initialize on a free
    localhost port): the mesh path's own collectives, at one rank an axis."""
    import socket

    from dexbotic_tpu_torch.parallel import multihost

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    multihost.maybe_initialize(f"localhost:{port}", 1, 0)


def attn_rows(q, k, v, ints, seg, dout, reps: int = 10) -> dict:
    """K1 and K3 at one shape: {"flash_fwd": row, "flash_bwd": row}, each with
    the kernel's time (CUDA events, median), its own device time
    (``device_ms``), its plain version's (3 calls),
    the bound, SDPA's time (the first backend that takes the mask; the
    backward by autograd through it) and the error against the fp32 plain
    version."""
    from dexbotic_tpu_torch.ops.attention import (
        _allowed,
        flash_attention_bwd,
        flash_attention_bwd_ref,
        flash_attention_fwd,
        flash_attention_ref,
    )

    sq = seg_pair(seg)
    out, lse = flash_attention_fwd(q, k, v, *ints, None, *sq)
    grads = flash_attention_bwd(q, k, v, *ints, out, lse, dout, None, *sq)
    with torch.no_grad():
        qf, kf, vf = q.float(), k.float(), v.float()
        ref_out, _ = flash_attention_ref(qf, kf, vf, *ints, None, *sq)
        ref_g = flash_attention_bwd_ref(qf, kf, vf, *ints, out.float(), lse, dout.float(), None,
                                        *sq)
    io_f, pairs = attn_counts(q, k, ints, seg, (q, k, v, out, lse))
    io_b, _ = attn_counts(q, k, ints, seg, (q, k, v, out, dout, lse, *grads))
    rows = {}
    for name, call, plain, io, ops, err in (
            ("flash_fwd", lambda: flash_attention_fwd(q, k, v, *ints, None, *sq),
             lambda: flash_attention_ref(q, k, v, *ints, None, *sq), io_f,
             4 * q.shape[-1] * pairs, (out.float() - ref_out).abs().max().item()),
            ("flash_bwd", lambda: flash_attention_bwd(q, k, v, *ints, out, lse, dout, None, *sq),
             lambda: flash_attention_bwd_ref(q, k, v, *ints, out, lse, dout, None, *sq), io_b,
             10 * q.shape[-1] * pairs,
             max((a.float() - r).abs().max().item() for a, r in zip(grads, ref_g)))):
        bound_ms, bound_by = bound(io, ops)
        rows[name] = {"ms": median_ms(call, reps), "plain_ms": median_ms(plain, 3),
                      "device_ms": device_ms(call, K1_KERNELS if name == "flash_fwd"
                                             else K3_KERNELS),
                      "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err,
                      "B_Sq_Skv": [q.shape[0], q.shape[1], k.shape[1]]}
    backend, leaves, call = sdpa(q, k, v, _allowed(*ints, *sq), backward=True)
    with torch.no_grad():
        rows["flash_fwd"]["library_ms"] = median_ms(call, LIB_REPS)
    lib_out = call()
    dout_t = dout.transpose(1, 2)
    rows["flash_bwd"]["library_ms"] = median_ms(
        lambda: torch.autograd.grad(lib_out, leaves, dout_t, retain_graph=True), LIB_REPS)
    for r in rows.values():
        r["sdpa_backend"] = backend
    del lib_out, leaves, ref_g, ref_out, grads
    return rows


def phase_navila_cp(failures: list, dataset: str, model, cfg) -> dict:
    """Phase 13e: one step of 13c's recipe (NaVILA-7B, 4 rows of 4096, the
    LLM frozen, remat, 13b's weights under the Trainer's bf16 rule) through
    navila_packed_loss_cp on a ('data', 'model', 'seq') = (1, 1, 1) mesh over
    a process group of one (NCCL): the ring code with one hop a layer call,
    held to navila_packed_loss on the same batch, loss and grad norm within
    PARALLEL_REL; K1, K3 and the ring's hops counted around each."""
    import torch.distributed as dist

    from dexbotic_tpu_torch.data.collator import Collator
    from dexbotic_tpu_torch.exp.optim import global_norm, is_frozen
    from dexbotic_tpu_torch.models.navila import navila_packed_loss, navila_packed_loss_cp
    from dexbotic_tpu_torch.parallel import multihost
    from dexbotic_tpu_torch.parallel.mesh import make_mesh, mesh_shape
    from dexbotic_tpu_torch.parallel.ring import ring_attention

    R = NAVILA_TRAIN_ROWS
    exp = navila_exp(dataset, "out_nav_cp", rows=R, train=True)
    tok = exp.tokenizer.build_tokenizer()
    ds = exp.data.build_data(exp.build_tokenization(tok))
    collator = Collator(pad_token_id=tok.pad_token_id, max_length=exp.tokenizer.model_max_length)
    host = next(exp.packed_batches(ds, collator, tok.pad_token_id, R))
    batch = {k: torch.as_tensor(v).cuda() for k, v in host.items()}
    soft = exp._digit_ids(tok)
    trainable = {n for n, _ in model.named_parameters() if not is_frozen(n, exp.optimizer)}
    group_of_one()
    mesh = make_mesh(data=1, model=1, seq=1)
    print(f"phase 13e: one packed NaVILA-7B step ({R} rows of {host['input_ids'].shape[1]}, "
          f"LLM frozen, remat, bf16 weights) through navila_packed_loss_cp on a "
          f"{mesh_shape(mesh)} mesh over a process group of one ({dist.get_backend()}), against "
          f"navila_packed_loss on the same batch")

    def run(cp: bool) -> dict:
        for n, p in model.named_parameters():
            p.requires_grad_(n in trainable)
        _zero_counts()
        hops = ring_attention.hops
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.enable_grad():
            loss, _ = (navila_packed_loss_cp(model, cfg, batch, mesh, soft, remat=True) if cp
                       else navila_packed_loss(model, cfg, batch, soft, remat=True))
            loss.backward()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launch_counts()
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        out = {"loss": float(loss.detach()), "grad_norm": float(global_norm(grads)),
               "launches": launches, "hops": ring_attention.hops - hops, "step_s": wall}
        for p in model.parameters():
            p.grad = None
        model.requires_grad_(False)
        free_memory()
        return out

    torch.cuda.reset_peak_memory_stats()
    try:
        plain = run(False)
        ring = run(True)
    finally:
        multihost.shutdown()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rel = {k: abs(ring[k] - plain[k]) / abs(plain[k]) for k in ("loss", "grad_norm")}
    L = cfg.vlm.llm.num_layers
    for label, w in (("navila_packed_loss_cp", ring), ("navila_packed_loss", plain)):
        print(f"  {label}: loss {w['loss']!r} grad_norm {w['grad_norm']!r}; {w['step_s']:.3f} s; "
              f"launches {w['launches']}; ring hops {w['hops']}")
    print(f"  rel loss {rel['loss']:.3g}, grad_norm {rel['grad_norm']:.3g} (bound {PARALLEL_REL}); "
          f"peak {peak:.2f} GiB")
    lr = ring["launches"]
    checks = [(max(rel.values()) <= PARALLEL_REL, f"13e: rel differences {rel} > {PARALLEL_REL}"),
              (ring["hops"] == lr["flash_fwd"] >= 2 * L and lr["flash_bwd"] == L
               and lr["plain_cuda_calls"] == 0,
               f"13e: ring hops {ring['hops']}, launches {lr}: want one K1 hop a layer call "
               f"(2 x {L} with remat), K3 {L}, no plain call"),
              (plain["hops"] == 0, "13e: the plain step ran the ring"),
              (not dist.is_initialized(), "13e: the process group outlived the phase")]
    failures.extend(msg for ok, msg in checks if not ok)
    return {"rows": R, "mesh": {"data": 1, "model": 1, "seq": 1}, "ring": ring, "plain": plain,
            "rel": rel, "peak_gib": peak}


def phase_ring_hops(failures: list) -> dict:
    """Phase 13f: the ring's hops at NaVILA-7B's layer shape (4 packed rows of
    4096, 32 heads of 128, 13c's segments), the sequence cut into n blocks
    (RING_SPLITS), each rank's hops run as that rank would in one process
    (parallel/ring.simulate: K1 hops merged, then K3 hops from the global
    out, lse and dO): out, lse, dq, dk and dv on the valid rows against the
    fp32 plain version over the whole sequence, each within 2x the whole-
    sequence K1/K3 call's error + 1e-3; each hop's K1 and K3 time, a rank's
    hops summed against one whole-sequence call, and the share of dead hops
    (every 64 x 64 tile dead)."""
    from dexbotic_tpu_torch.ops.attention import (
        DEAD,
        flash_attention_bwd,
        flash_attention_bwd_ref,
        flash_attention_fwd,
        flash_attention_ref,
        flash_tile_classes,
    )
    from dexbotic_tpu_torch.parallel.ring import simulate

    g = torch.Generator(device="cuda").manual_seed(18)
    name, q, k, v, ints, seg = navila_attn_inputs("packed", NAVILA_TRAIN_ROWS, g)
    dout = torch.randn(q.shape, generator=g, device="cuda").bfloat16()
    B, S = q.shape[:2]
    print(f"phase 13f: ring hops at {name}, split in {RING_SPLITS} blocks")
    out, lse = flash_attention_fwd(q, k, v, *ints, None, seg, seg)
    whole = dict(zip(("dq", "dk", "dv"), flash_attention_bwd(q, k, v, *ints, out, lse, dout, None,
                                                              seg, seg)), out=out, lse=lse)
    whole_ms = {"flash_fwd": median_ms(lambda: flash_attention_fwd(q, k, v, *ints, None, seg, seg),
                                       5),
                "flash_bwd": median_ms(lambda: flash_attention_bwd(q, k, v, *ints, out, lse, dout,
                                                                   None, seg, seg), 5)}
    valid = ints[2].bool()
    ref: dict = {}
    for b in range(B):  # the fp32 reference a row at a time: [32, 4096, 4096] scores
        sl = slice(b, b + 1)
        args = [t[sl] for t in ints]
        qf, kf, vf = (t[sl].float() for t in (q, k, v))
        with torch.no_grad():
            o, l_ = flash_attention_ref(qf, kf, vf, *args, None, seg[sl], seg[sl])
            grads = flash_attention_bwd_ref(qf, kf, vf, *args, o, l_, dout[sl].float(), None,
                                            seg[sl], seg[sl])
        for key, t in zip(("out", "lse", "dq", "dk", "dv"), (o, l_, *grads)):
            ref.setdefault(key, []).append(t)
        del o, l_, grads, qf, kf, vf
    ref = {key: torch.cat(ts) for key, ts in ref.items()}

    def on_valid(key, t):
        return (t.transpose(1, 2) if key == "lse" else t)[valid].float()

    whole_err = {key: (on_valid(key, whole[key]) - on_valid(key, ref[key])).abs().max().item()
                 for key in ref}
    result = {"whole_ms": whole_ms, "whole_err": whole_err}
    for n in RING_SPLITS:
        sim = simulate(q, k, v, *ints, seg, seg, n=n, dout=dout)
        err = {key: (on_valid(key, sim[key]) - on_valid(key, ref[key])).abs().max().item()
               for key in ref}
        for key in ref:
            check_bound(f"13f n={n} {key}", err[key], whole_err[key], failures)
        del sim
        L = S // n

        def blk(t, r):
            return t[:, r * L: (r + 1) * L]

        hops, dead = [], 0
        for r in range(n):  # rank r's hops: its queries against block (r - h) % n
            for h in range(n):
                j = (r - h) % n
                qi = [blk(t, r) for t in (q, ints[0], seg, dout)]
                kv = [blk(t, j) for t in (k, v, ints[1], ints[2], seg)]
                o, l_ = flash_attention_fwd(qi[0], kv[0], kv[1], qi[1], kv[2], kv[3], None, qi[2],
                                            kv[4])
                cls = flash_tile_classes(qi[1], kv[2], kv[3], qi[2], kv[4])
                is_dead = bool((cls == DEAD).all())
                dead += is_dead
                fwd_ms = median_ms(lambda: flash_attention_fwd(
                    qi[0], kv[0], kv[1], qi[1], kv[2], kv[3], None, qi[2], kv[4]), 5)
                bwd_ms = median_ms(lambda: flash_attention_bwd(
                    qi[0], kv[0], kv[1], qi[1], kv[2], kv[3], o, l_, qi[3], None, qi[2], kv[4]), 5)
                hops.append({"rank": r, "block": j, "flash_fwd_ms": fwd_ms,
                             "flash_bwd_ms": bwd_ms, "dead": is_dead})
        sums = {kern: [sum(hp[f"{kern}_ms"] for hp in hops if hp["rank"] == r) for r in range(n)]
                for kern in ("flash_fwd", "flash_bwd")}
        # the table's row: the diagonal hop of rank 0 (its own block, the causal edge)
        rows = attn_rows(blk(q, 0), blk(k, 0), blk(v, 0), tuple(blk(t, 0) for t in ints),
                         blk(seg, 0), blk(dout, 0), reps=5)
        print(f"  n={n}: blocks of {L}; hops (rank, block, K1 ms, K3 ms, dead): "
              + ", ".join(f"({hp['rank']}, {hp['block']}, {hp['flash_fwd_ms']:.4f}, "
                          f"{hp['flash_bwd_ms']:.4f}{', dead' if hp['dead'] else ''})"
                          for hp in hops))
        print(f"    a rank's hops summed: K1 {[round(x, 4) for x in sums['flash_fwd']]} ms, K3 "
              f"{[round(x, 4) for x in sums['flash_bwd']]} ms, against one whole-sequence call: "
              f"K1 {whole_ms['flash_fwd']:.4f} ms, K3 {whole_ms['flash_bwd']:.4f} ms; dead hops "
              f"{dead} of {n * n} ({dead / (n * n):.1%})")
        for kern, row in rows.items():
            print(f"    {kern} at the diagonal hop {row['B_Sq_Skv']}: {row['ms']:.4f} ms, plain "
                  f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
                  f"SDPA ({row['sdpa_backend']}) {row['library_ms']:.4f} ms")
        result[f"n{n}"] = {"err": err, "hops": hops, "rank_sums_ms": sums,
                           "dead_hop_share": dead / (n * n), "rows": rows}
    free_memory()
    return result


def phase_moe(failures: list) -> dict:
    """Phase 16a: an MoE decoder at LLaMA-2-7B's layer width (MOE_CFG: 2
    layers, 8 experts, top-2, capacity 2.0, bf16 under the Trainer's rule) on MOE_ROWS x
    MOE_TOKENS causal rows: mot_forward(want_aux=True) forward and backward
    through K1 and K3 (counted), held against the same model on the plain
    attention path (outputs, the input's and the router's, experts' and
    attention's gradients at cosine >= MOE_COSINE, the balance loss within
    1e-3 relative); the dropped share, and one layer's expert FFN time
    against its attention's (K1 and K3, with the kernel table's row)."""
    from dexbotic_tpu_torch.nn import moe
    from dexbotic_tpu_torch.nn.core import cast_like_jax_
    from dexbotic_tpu_torch.nn.transformer import (
        Stream,
        Transformer,
        TransformerConfig,
        init_transformer_,
        mot_forward,
    )

    cfg = TransformerConfig(**MOE_CFG)
    with torch.device("meta"):
        model = Transformer(cfg)
    model = model.to_empty(device="cuda")
    init_transformer_(model, torch.Generator(device="cuda").manual_seed(16))
    cast_like_jax_(model, torch.bfloat16)
    rule = print_bf16_rule("16a's decoder", model)
    g = torch.Generator(device="cuda").manual_seed(17)
    B, T, H = MOE_ROWS, MOE_TOKENS, cfg.hidden_size
    x = torch.randn(B, T, H, generator=g, device="cuda").bfloat16()
    dout = torch.randn(B, T, H, generator=g, device="cuda").bfloat16()
    pos = torch.arange(T, device="cuda", dtype=torch.int32)[None].expand(B, T).contiguous()
    valid = torch.ones(B, T, dtype=torch.int32, device="cuda")
    print(f"phase 16a: MoE decoder at LLaMA-2-7B width ({cfg.num_layers} layers, "
          f"{cfg.moe_num_experts} experts, top-{cfg.moe_top_k}, capacity "
          f"{cfg.moe_capacity_factor}; {sum(p.numel() for p in model.parameters()) / 1e9:.2f}B "
          f"parameters, bf16) on {B} x {T} causal rows: mot_forward(want_aux=True) forward and "
          f"backward, kernel path vs plain path")
    stats: list = []
    moe_mlp = moe.moe_mlp

    def recorded(*a, **kw):
        stats.append({})
        kw["stats"] = stats[-1]
        return moe_mlp(*a, **kw)

    watched = {"router": ".mlp.router.", "experts": ".mlp.", "attention": ".attn."}

    def run(impl):
        model.requires_grad_(True)
        xi = x.clone().requires_grad_(True)
        c = dataclasses.replace(cfg, attn_impl=impl)
        stats.clear()
        _zero_counts()
        moe.moe_mlp = recorded
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            outs, _, aux = mot_forward([Stream(c, model, xi)], pos, pos + 1, valid, want_aux=True)
            loss = (outs[0].float() * dout.float()).sum() + aux["moe_aux"]
            loss.backward()
        finally:
            moe.moe_mlp = moe_mlp
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        named = dict(model.named_parameters())
        grads = {"input": xi.grad.float().flatten()}
        grads.update({k: torch.cat([p.grad.float().flatten() for n, p in named.items()
                                    if sub in n and (k != "experts" or ".router." not in n)])
                      for k, sub in watched.items()})
        out = {"out": outs[0].detach().float().flatten(), "aux": float(aux["moe_aux"].detach()),
               "launches": _launch_counts(), "step_s": wall,
               "dropped_share": [st["dropped_share"] for st in stats],
               "capacity": stats[0]["capacity"]}
        model.zero_grad(set_to_none=True)
        model.requires_grad_(False)
        return out, grads

    kern, gk = run("auto")
    plain, gp = run("xla")
    cos = {"out": _cosine(kern.pop("out"), plain.pop("out")),
           **{k: _cosine(gk[k], gp[k]) for k in gk}}
    aux_rel = abs(kern["aux"] - plain["aux"]) / abs(plain["aux"])
    del gk, gp
    free_memory()
    # one layer's expert FFN (three batched products on the [E, C, H] buffer)
    # against its attention (K1, K3) at the layer's shape
    layer = model.layers[0].mlp
    C = kern["capacity"]
    xs = torch.randn(cfg.moe_num_experts, C, H, generator=g, device="cuda").bfloat16()
    with torch.no_grad():
        ffn_ms = median_ms(lambda: moe._experts(layer, xs, cfg.act), 10)
    q, k_, v = (torch.randn(B, T, cfg.num_heads, cfg.head_dim, generator=g,
                            device="cuda").bfloat16() for _ in range(3))
    rows = attn_rows(q, k_, v, (pos + 1, pos + 1, valid), None,
                     torch.randn(q.shape, generator=g, device="cuda").bfloat16())
    print(f"  kernel path: {kern['step_s']:.3f} s, launches {kern['launches']}; plain path: "
          f"{plain['step_s']:.3f} s, launches {plain['launches']}")
    print(f"  cosine kernel vs plain: {cos}; balance loss {kern['aux']!r} vs {plain['aux']!r} "
          f"(rel {aux_rel:.3g}); capacity {C} slots an expert; dropped share a layer "
          f"{kern['dropped_share']}")
    print(f"  one layer: expert FFN {ffn_ms:.4f} ms ([{cfg.moe_num_experts}, {C}, {H}] through "
          f"gate/up/down) against K1 {rows['flash_fwd']['ms']:.4f} ms and K3 "
          f"{rows['flash_bwd']['ms']:.4f} ms (SDPA {rows['flash_fwd']['library_ms']:.4f} / "
          f"{rows['flash_bwd']['library_ms']:.4f} ms); K1 bound {rows['flash_fwd']['bound_ms']:.4f}"
          f" ms, K3 {rows['flash_bwd']['bound_ms']:.4f} ms")
    L = cfg.num_layers
    lk = kern["launches"]
    checks = [(min(cos.values()) >= MOE_COSINE, f"16a: cosines {cos} < {MOE_COSINE}"),
              (aux_rel <= 1e-3, f"16a: balance loss rel {aux_rel} > 1e-3"),
              (lk["flash_fwd"] == L and lk["flash_bwd"] == L and lk["plain_cuda_calls"] == 0,
               f"16a: kernel path launches {lk}, want K1 {L}, K3 {L}, no plain call"),
              (plain["launches"]["flash_fwd"] == plain["launches"]["flash_bwd"] == 0,
               f"16a: the plain path launched {plain['launches']}")]
    failures.extend(msg for ok, msg in checks if not ok)
    del model, layer, xs
    free_memory()
    return {"kernel": kern, "plain": plain, "cosine": cos, "aux_rel": aux_rel,
            "expert_ffn_ms": ffn_ms, "rows": rows, **rule}


def kernel_batch_invariance(cfg, pos, valid, g) -> dict:
    """K1 and K3 on the same bf16 inputs [PP_ROWS, PP_TOKENS, H, D] (causal
    groups), whole and as PP_MICRO micro-batches: the largest difference of
    each output between the two (0: a row's result does not depend on the
    batch it is in).  K1 takes 128-row blocks at the whole batch's shape
    and 64-row ones at a micro-batch's (``ops/attention.fwd_rows``), so the
    whole batch is also run at 64 rows."""
    from dexbotic_tpu_torch.ops.attention import (
        _flash_cuda,
        flash_attention_bwd,
        flash_attention_fwd,
    )

    q, k, v, dout = (torch.randn(PP_ROWS, PP_TOKENS, cfg.num_heads, cfg.head_dim, generator=g,
                                 device="cuda").bfloat16() for _ in range(4))
    ints = (pos, pos, valid)
    scale = cfg.head_dim ** -0.5
    out, lse = flash_attention_fwd(q, k, v, *ints)
    out64, lse64 = _flash_cuda(q, k, v, *ints, scale, None, None, rows=64)
    grads = flash_attention_bwd(q, k, v, *ints, out, lse, dout)
    parts = [(flash_attention_fwd(*c[:6]), c) for c in
             zip(*(t.chunk(PP_MICRO) for t in (q, k, v, pos, pos, valid, out, lse, dout)))]
    out_m = torch.cat([o for (o, _), _ in parts])
    lse_m = torch.cat([lse_ for (_, lse_), _ in parts])
    grads_m = [torch.cat(t) for t in zip(*(flash_attention_bwd(*c) for _, c in parts))]

    def diff(a, b):
        return (a.float() - b.float()).abs().max().item()

    return {"k1_rows": {"whole": fwd_rows_of(q), "micro": fwd_rows_of(q[: PP_ROWS // PP_MICRO])},
            "k1_out": diff(out, out_m), "k1_lse": diff(lse, lse_m),
            "k1_out_at_64_rows": diff(out64, out_m), "k1_lse_at_64_rows": diff(lse64, lse_m),
            "k3": {n: diff(a, b) for n, a, b in zip(("dq", "dk", "dv"), grads, grads_m)}}


def fwd_rows_of(q) -> int:
    from dexbotic_tpu_torch.ops.attention import _sm_count, fwd_rows

    B, S, H, D = q.shape
    return fwd_rows(B, S, H, _sm_count(q.device.index), D)


def phase_pipeline(failures: list) -> dict:
    """Phase 16b: the GPipe pipeline on a ('stage', 'data') = (1, 1) mesh
    over a process group of one (NCCL), n_micro PP_MICRO, a PP_CFG decoder
    (4 layers at LLaMA-2-7B's width, fp32 weights; K1 and K3 take q/k/v
    rounded to bf16) on PP_ROWS x PP_TOKENS causal rows.

    The checked step is the causal-LM loss on fp32 embeddings
    (``pipeline_transformer_forward``, then ``lm_loss``), held within
    PARALLEL_REL to the unpipelined loss (``transformer_forward``, the same
    loss): over the whole batch, the loss and the grad norm; over the same
    micro-batches (one transformer_forward each, the loss over their
    concatenation), every gradient (the relative norm of the difference).
    ``pipeline_causal_lm_loss`` (bf16 embeddings, as the JAX loss) is then
    run once: a finite loss, K1 and K3 on every micro-batch and layer.

    Against the whole batch the kernel path's gradients differ by ~1e-3 (a
    reading), and so do they when each embedding moves by one fp32 ulp with
    no change of batch (a reading): K3's bf16 intermediates amplify
    last-bit differences.  Checked beside it: the same whole-batch gap on
    the plain fp32 attention (``attn_impl="xla"``) within PARALLEL_REL, and
    K1 (at one block height) and K3 giving a row the same bits whole and
    micro-batched (:func:`kernel_batch_invariance`)."""
    import torch.distributed as dist

    from dexbotic_tpu_torch.exp.optim import global_norm
    from dexbotic_tpu_torch.nn.transformer import (
        Transformer,
        TransformerConfig,
        embed_tokens,
        init_transformer_,
        transformer_forward,
    )
    from dexbotic_tpu_torch.parallel import multihost
    from dexbotic_tpu_torch.parallel.mesh import make_pipeline_mesh, mesh_shape
    from dexbotic_tpu_torch.parallel.pipeline import (
        lm_loss,
        pipeline_causal_lm_loss,
        pipeline_transformer_forward,
    )

    cfg = TransformerConfig(**PP_CFG)
    with torch.device("meta"):
        model = Transformer(cfg)
    model = model.to_empty(device="cuda")
    init_transformer_(model, torch.Generator(device="cuda").manual_seed(19))
    g = torch.Generator(device="cuda").manual_seed(20)
    ids = torch.randint(1, cfg.vocab_size, (PP_ROWS, PP_TOKENS), generator=g, device="cuda")
    valid = torch.ones_like(ids, dtype=torch.int32)
    pos = torch.cumsum(valid, 1, dtype=torch.int32) - 1
    batch = {"input_ids": ids, "attention_mask": valid, "labels": ids}
    group_of_one()
    mesh = make_pipeline_mesh(1, 1)
    print(f"phase 16b: the pipelined causal-LM loss on a {mesh_shape(mesh)} mesh over a process "
          f"group of one ({dist.get_backend()}), n_micro {PP_MICRO}, a {cfg.num_layers}-layer "
          f"decoder at LLaMA-2-7B width (fp32) on {PP_ROWS} x {PP_TOKENS}, against the "
          f"unpipelined loss")
    model.requires_grad_(True)

    def grads_and_norm():
        named = {n: p.grad for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return named, float(global_norm(list(named.values())))

    def unpipelined(parts: int, c=cfg, ulp: bool = False, remat: bool = False):
        """The unpipelined loss over ``parts`` micro-batches, backward, on
        fp32 embeddings (each moved one ulp in a random direction with
        ``ulp``); (loss, s)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = embed_tokens(model, c, ids, dtype=torch.float32)
        if ulp:
            up = torch.rand(x.shape, generator=g, device="cuda") < 0.5
            x = x + (torch.nextafter(x, torch.where(up, math.inf, -math.inf)) - x).detach()
        hidden = torch.cat([transformer_forward(c, model, xc, pc, pc, vc, remat=remat)
                            for xc, pc, vc in zip(x.chunk(parts), pos.chunk(parts),
                                                  valid.chunk(parts))])
        loss = lm_loss(model, c, hidden, batch)
        loss.backward()
        torch.cuda.synchronize()
        return float(loss.detach()), time.perf_counter() - t0

    def rel_diff(a: dict, b: dict, norm: float) -> float:
        return math.sqrt(sum(float((a[n].float() - b[n].float()).square().sum())
                             for n in b)) / norm

    try:
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = embed_tokens(model, cfg, ids, dtype=torch.float32)
        hidden = pipeline_transformer_forward(cfg, model, x, pos, pos, valid, mesh,
                                              n_micro=PP_MICRO)
        loss_pp = lm_loss(model, cfg, hidden, batch)
        loss_pp.backward()
        torch.cuda.synchronize()
        pp_s = time.perf_counter() - t0
        launches = _launch_counts()
        loss_pp = float(loss_pp.detach())
        del x, hidden
        g_pp, norm_pp = grads_and_norm()
        _zero_counts()
        loss_bf16 = pipeline_causal_lm_loss(model, cfg, batch, mesh, n_micro=PP_MICRO)
        loss_bf16.backward()
        entry_launches = _launch_counts()
        loss_bf16 = float(loss_bf16.detach())
        model.zero_grad(set_to_none=True)
    finally:
        multihost.shutdown()
    loss_whole, whole_s = unpipelined(1)
    g_ref, norm_whole = grads_and_norm()
    whole_grads = rel_diff(g_pp, g_ref, norm_whole)
    unpipelined(1, ulp=True)
    g_ulp, _ = grads_and_norm()
    witness = {"kernel_one_ulp_whole_batch": rel_diff(g_ulp, g_ref, norm_whole)}
    del g_ref, g_ulp
    free_memory()
    _, micro_s = unpipelined(PP_MICRO)
    g_ref, norm_micro = grads_and_norm()
    rel = {"loss": abs(loss_pp - loss_whole) / abs(loss_whole),
           "grad_norm": abs(norm_pp - norm_whole) / norm_whole,
           "grads_same_micro_batches": rel_diff(g_pp, g_ref, norm_micro)}
    del g_pp, g_ref
    free_memory()
    plain = dataclasses.replace(cfg, attn_impl="xla")
    unpipelined(1, plain, remat=True)
    g_plain, norm_plain = grads_and_norm()
    unpipelined(PP_MICRO, plain, remat=True)
    g_plain_m, _ = grads_and_norm()
    witness["plain_fp32_micro_vs_whole"] = rel_diff(g_plain_m, g_plain, norm_plain)
    del g_plain, g_plain_m, model
    free_memory()
    witness.update(kernel_batch_invariance(cfg, pos, valid, g))
    free_memory()
    L = cfg.num_layers
    print(f"  pipelined: loss {loss_pp!r} grad_norm {norm_pp!r} {pp_s:.3f} s, launches "
          f"{launches}; unpipelined, whole batch: loss {loss_whole!r} grad_norm {norm_whole!r} "
          f"{whole_s:.3f} s; over the same micro-batches {micro_s:.3f} s; rel {rel} (bound "
          f"{PARALLEL_REL}); the gradients against the whole batch's (a reading): rel "
          f"{whole_grads:.3g}")
    print(f"  pipeline_causal_lm_loss (bf16 embeddings): loss {loss_bf16!r}, launches "
          f"{entry_launches}")
    print(f"  witnesses of the whole-batch gap (readings): {json.dumps(witness)}")
    want = L * PP_MICRO
    checks = [(max(rel.values()) <= PARALLEL_REL, f"16b: rel differences {rel} > {PARALLEL_REL}"),
              (launches["flash_fwd"] == launches["flash_bwd"] == want
               and launches["plain_cuda_calls"] == 0,
               f"16b: launches {launches}, want K1 and K3 {want}, no plain call"),
              (math.isfinite(loss_bf16) and entry_launches["flash_fwd"] == want
               == entry_launches["flash_bwd"] and entry_launches["plain_cuda_calls"] == 0,
               f"16b: pipeline_causal_lm_loss gave {loss_bf16} with launches {entry_launches}"),
              (witness["plain_fp32_micro_vs_whole"] <= PARALLEL_REL,
               f"16b: the plain fp32 path's gradients, whole batch against micro-batches: rel "
               f"{witness['plain_fp32_micro_vs_whole']} > {PARALLEL_REL}"),
              (witness["k1_out_at_64_rows"] == witness["k1_lse_at_64_rows"] == 0
               and not any(witness["k3"].values()),
               f"16b: K1 or K3 gives a row other bits whole than micro-batched: {witness}"),
              (not dist.is_initialized(), "16b: the process group outlived the phase")]
    failures.extend(msg for ok, msg in checks if not ok)
    q, k_, v = (torch.randn(PP_ROWS // PP_MICRO, PP_TOKENS, cfg.num_heads, cfg.head_dim,
                            generator=g, device="cuda").bfloat16() for _ in range(3))
    p1 = pos[: PP_ROWS // PP_MICRO]
    rows = attn_rows(q, k_, v, (p1, p1, valid[:1]), None,  # a micro-batch's causal groups
                     torch.randn(q.shape, generator=g, device="cuda").bfloat16())
    return {"launches": launches, "rel": rel, "whole_batch_grads_rel": whole_grads,
            "witness": witness, "entry_loss_bf16": loss_bf16, "entry_launches": entry_launches,
            "pipelined_s": pp_s, "unpipelined_s": whole_s, "loss": loss_pp, "rows": rows}


def phase_parallel(failures: list) -> dict:
    """Phase 16: MoE (16a) and GPipe stages (16b)."""
    moe = phase_moe(failures)
    free_memory()
    pp = phase_pipeline(failures)
    free_memory()
    return {"16a_moe": moe, "16b_pipeline": pp}


def build_report(log: str, failures: list) -> tuple[dict, dict, dict, dict]:
    """Registers and spills of every K1 instance ("flash_fwd_kernel<D, NWG,
    BK>"), every K3 instance ("dkv_kernel<D, NWG, stages>" at head dims 64
    and 128, "dkv256_kernel", "dkv_sum_kernel" and "dq256_kernel" at 256,
    "dq_kernel<D, NWG, stages>"), every K4 instance ("qm_kernel<x dtype, rows, NWG>") and every
    K2 instance ("dit_sample_kernel<weight dtype, int8 blocks>") from nvcc's
    ``-Xptxas -v`` output, as (K1's, K3's, K4's, K2's); a spilling instance
    fails, and so do a missing head_dim-256 K1 or K3 kernel and a missing K4
    or K2 instance."""
    import re

    report, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(flash_fwd_kernel|dkv_kernel|dq_kernel)I((?:Li\d+E)+)E", m.group(1))
            qk = re.search(r"qm_kernelI(13__nv_bfloat16|f)Li(\d+)ELi(\d+)E", m.group(1))
            dk = re.search(r"dit_sample_kernelI(13__nv_bfloat16|f)Lb([01])E", m.group(1))
            k3_256 = re.search(r"\d(dkv256_kernel|dkv_sum_kernel|dq256_kernel)E", m.group(1))
            name = None
            if k3_256:  # K3's head_dim-256 kernels (no template)
                name = k3_256.group(1)
            elif k:
                args = ", ".join(re.findall(r"Li(\d+)E", k.group(2)))
                name = f"{k.group(1)}<{args}>"
            elif qk:
                dt = "bf16" if qk.group(1) != "f" else "f32"
                name = f"qm_kernel<{dt}, {qk.group(2)}, {qk.group(3)}>"
            elif dk:
                dt = "bf16" if dk.group(1) != "f" else "f32"
                name = f"dit_sample_kernel<{dt}, {'int8' if dk.group(2) == '1' else 'dense'}>"
        elif name and "spill stores" in line:
            report[name] = {"spill_bytes": sum(int(x) for x in re.findall(r"(\d+) bytes spill", line))}
        elif name and "registers" in line:
            report[name]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            name = None
    for n, r in sorted(report.items()):
        print(f"  {n}: {r.get('registers')} registers, {r['spill_bytes']} bytes of spills")
        if r["spill_bytes"]:
            failures.append(f"{n} spills {r['spill_bytes']} bytes")
    k1 = {n: r for n, r in report.items() if n.startswith("flash_fwd_kernel")}
    k3 = {n: r for n, r in report.items() if n.startswith(("dkv", "dq"))}
    k4 = {n: r for n, r in report.items() if n.startswith("qm_kernel")}
    k2 = {n: r for n, r in report.items() if n.startswith("dit_sample_kernel")}
    if not any(n.startswith("flash_fwd_kernel<256,") for n in k1):
        failures.append("nvcc's output lists no flash_fwd_kernel instance at head_dim 256")
    for kernel in ("dkv256_kernel", "dkv_sum_kernel", "dq256_kernel"):
        if kernel not in k3:
            failures.append(f"nvcc's output lists no {kernel}")
    for t, r, nwg in K4_INSTANCES:
        if f"qm_kernel<{t}, {r}, {nwg}>" not in k4:
            failures.append(f"nvcc's output lists no qm_kernel<{t}, {r}, {nwg}>")
    for n in K2_INSTANCES:
        if n not in k2:
            failures.append(f"nvcc's output lists no {n}")
    return k1, k3, k4, k2


# K2's instances (weight dtype, int8 blocks): the bf16 ones run their
# products on wgmma, the fp32 ones (off the served path) on FMA
K2_INSTANCES = [f"dit_sample_kernel<{t}, {q}>" for t in ("bf16", "f32") for q in ("dense", "int8")]


def start_sass_dump(so: str):
    """``cuobjdump -sass`` of the built library, started beside the phase
    that follows: (the process, the file it writes) or None where the
    toolkit has no cuobjdump."""
    import shutil

    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    tool = tool if os.path.exists(tool) else shutil.which("cuobjdump")
    if tool is None:
        return None
    out = tempfile.TemporaryFile(mode="w+")
    return subprocess.Popen([tool, "-sass", so], stdout=out, stderr=subprocess.DEVNULL, text=True), out


def k2_sass_report(dump, k2: dict, failures: list) -> None:
    """The HGMMA instructions of every K2 instance in the built library's
    SASS (``start_sass_dump``'s), into ``k2``; a bf16 instance without one
    fails."""
    import re

    if dump is None:
        failures.append("no cuobjdump: K2's SASS cannot be checked for HGMMA")
        return
    proc, out = dump
    proc.wait(timeout=600)
    out.seek(0)
    sass = out.read()
    out.close()
    for chunk in sass.split("Function : ")[1:]:
        m = re.match(r"\S*dit_sample_kernelI(13__nv_bfloat16|f)Lb([01])E", chunk)
        if m:
            name = (f"dit_sample_kernel<{'bf16' if m.group(1) != 'f' else 'f32'}, "
                    f"{'int8' if m.group(2) == '1' else 'dense'}>")
            k2.setdefault(name, {})["hgmma"] = chunk.count("HGMMA")
    for n in K2_INSTANCES:
        hg = k2.get(n, {}).get("hgmma", 0)
        print(f"  {n}: {hg} HGMMA instructions in its SASS")
        if n.startswith("dit_sample_kernel<bf16") and hg == 0:
            failures.append(f"{n}'s SASS holds no HGMMA")


def free_memory() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one", file=sys.stderr)
        return 2
    from dexbotic_tpu_torch.kernels import build

    print(card_line())
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    start = last = time.perf_counter()

    def lap(phase: str) -> None:
        """The seconds of the phase just run, and since the start."""
        nonlocal last
        now = time.perf_counter()
        print(f"[{phase}: {now - last:.1f} s; {now - start:.1f} s in all]", flush=True)
        last = now
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.load()
    print(f"phase 2: kernels built/loaded in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {build.LIBRARY.build_seconds})")
    failures: list = []
    log = build.LIBRARY.build_log
    if not log:  # built by an earlier process: its nvcc output is beside the library
        with open(os.path.join(build.BUILD_DIR, "build.log")) as f:
            log = f.read()
    k1_build, k3_build, k4_build, k2_build = build_report(log, failures)
    k1 = phase_flash(failures)
    lap("phase_flash")
    k1_flow = phase_flash_flow(failures)
    lap("phase_flash_flow")
    k2 = phase_dit(failures)
    lap("phase_dit")
    k2q = phase_dit(failures, int8=True)
    lap("phase_dit")
    k4 = phase_quant_matmul(failures)
    lap("phase_quant_matmul")
    serve = phase_slice(failures)
    lap("phase_slice")
    fused = phase_fused_preprocess(failures, serve)
    lap("phase_fused_preprocess")
    replay = phase_replay_cogact(failures, serve)
    lap("phase_replay_cogact")
    harness = phase_harness(failures, serve)
    lap("phase_harness")
    for key in ("model", "exp", "tokenizer", "norms", "inputs"):
        del serve[key]
    free_memory()  # the serving model
    serve_q = phase_slice(failures, quantize="w8a8", bf16=serve)
    lap("phase_slice")
    free_memory()
    pi0 = phase_pi0(failures)
    lap("phase_pi0")
    pi0_q = phase_pi0_replay(failures, pi0)
    lap("phase_pi0_replay")
    free_memory()
    pi05 = phase_flow_serve(failures, "pi05")
    lap("phase_flow_serve")
    dm0 = phase_flow_serve(failures, "dm0")
    lap("phase_flow_serve")
    launches, launches_q = serve["launches"], serve_q["launches"]
    oft = phase_oft(failures)
    lap("phase_oft")
    oft_q = phase_oft_int8(failures, oft)
    lap("phase_oft_int8")
    for key in ("model", "heads", "exp", "tokenizer"):
        del oft[key]
    free_memory()
    k3 = phase_flash_bwd(failures)
    lap("phase_flash_bwd")
    # K2's SASS is read beside phase 7, whose steps take seconds: beside no
    # timing of a kernel
    sass = start_sass_dump(build.LIBRARY.path)
    rule_printed = contextlib.ExitStack()
    rule_printed.enter_context(trainer_rule_printed())
    train = phase_train(failures)
    lap("phase_train")
    k2_sass_report(sass, k2_build, failures)
    free_memory()
    pi0_train = phase_pi0_train(failures)
    lap("phase_pi0_train")
    free_memory()
    flow_train = phase_flow_train(failures)
    lap("phase_flow_train")
    free_memory()
    hybrid = phase_hybrid(failures)
    lap("phase_hybrid")
    free_memory()
    oft_train = phase_oft_train(failures)
    lap("phase_oft_train")
    free_memory()
    rl = phase_rl(failures)
    lap("phase_rl")
    free_memory()
    mem = phase_memvla(failures)
    lap("phase_memvla")
    mem_q = phase_memvla_int8(failures, mem)
    lap("phase_memvla_int8")
    for key in ("model", "exp", "cfg", "tokenizer", "pngs", "inputs", "noises", "kernel_chunks"):
        del mem[key]
    free_memory()
    mem_train = phase_memvla_train(failures)
    lap("phase_memvla_train")
    free_memory()
    nav = phase_navila(failures)
    lap("phase_navila")
    free_memory()
    discrete = phase_discrete(failures)
    lap("phase_discrete")
    free_memory()
    discrete_q = phase_discrete_quant(failures)
    lap("phase_discrete_quant")
    free_memory()
    muvla = phase_muvla(failures)
    lap("phase_muvla")
    free_memory()
    muvla_q = phase_muvla_quant(failures, muvla.pop("engine_tokens"))
    lap("phase_muvla_quant")
    free_memory()
    par = phase_parallel(failures)
    lap("phase_parallel")
    rule_printed.close()
    free_memory()
    if failures:
        print("FAILED:\n  " + "\n  ".join(failures), file=sys.stderr)
        return 1
    oft_routes = {route: {k: v for k, v in oft[route].items()
                          if k not in ("chunk", "inputs", "noise", "logits")}
                  for route, _ in OFT_ROUTES}
    print(json.dumps({"phases": {
        "5d_fused_preprocess": {k: v for k, v in fused.items() if k != "client"},
        "5e_replay_cogact": replay,
        "5f_pi0_replay_int8": {k: v for k, v in pi0_q.items()},
        "5g_oft": {**{k: v for k, v in oft.items() if k in ("prompt_tokens", "bf16_weight_bytes",
                                                            "head_params", "launches")},
                   **oft_routes},
        "5b_dumps": serve_q["dumps"], "5h_oft_int8": oft_q, "7c_mesh_train": train["7c_mesh"],
        "9_oft_train": oft_train,
        "10_rl": rl, "11a_memvla": mem,
        "11b_memvla_int8": mem_q, "12_memvla_train": mem_train, "13_navila": nav,
        "14_discrete": discrete, "14d_muvla": muvla, "14e_discrete_quant": discrete_q,
        "14f_muvla_quant": muvla_q, "15a_pi05": pi05, "15b_dm0": dm0,
        "15c_flow_train": flow_train, "15d_hybrid": hybrid, "15e_harness": harness,
        "16_parallel": par}}, default=float))
    fleet = nav["13a_serve"]["14c_fleet"]
    d_routes, m_routes = discrete["14a_serve"]["routes"], muvla["routes"]
    dq_routes, mq_routes = discrete_q["routes"], muvla_q["routes"]
    engine_keys = {  # each kernel's launches on the decode engine's paths (14a-14f), measured
        "flash_fwd": {"discrete_engine_launches": d_routes["engine"]["launches"]["flash_fwd"],
                      **{f"discrete_32_layers_{r}_launches": dq_routes[r]["launches"]["flash_fwd"]
                         for r in dq_routes},
                      **{f"muvla_{r}_launches": mq_routes[r]["launches"]["flash_fwd"]
                         for r in mq_routes},
                      "discrete_train_launches": discrete["14b_train"]["launches"]["flash_fwd"],
                      "navila_fleet_launches": fleet["launches"]["flash_fwd"],
                      "muvla_launches": m_routes["sequential"]["launches"]["flash_fwd"],
                      "muvla_engine_launches": m_routes["engine"]["launches"]["flash_fwd"],
                      "muvla_train_launches": muvla["train"]["launches"]["flash_fwd"]},
        "flash_bwd": {"discrete_train_launches": discrete["14b_train"]["launches"]["flash_bwd"],
                      "muvla_train_launches": muvla["train"]["launches"]["flash_bwd"]},
        "quant_matmul": {**{f"discrete_{r}_launches": dq_routes[r]["launches"]["quant_matmul"]
                            for r in ("int8", "w8a8")},
                         **{f"muvla_{r}_launches": mq_routes[r]["launches"]["quant_matmul"]
                            for r in ("int8", "w8a8")}}}
    rl_train = rl["10b_train_rl"]
    rl_keys = {  # each kernel's launches on the GRPO paths (10b's runs, 10c's rollout call),
        # MemVLA's (11a, 11b, 12b) and NaVILA's (13a's requests, 13c's steps)
        "flash_fwd": {"rl_train_launches": sum(r["launches"]["flash_fwd"] for r in rl_train.values()),
                      "rl_rollout_launches": rl["10c_rollouts"]["launches"],
                      "memvla_launches": mem["launches"]["flash_fwd"],
                      "memvla_int8_launches": mem_q["launches"]["flash_fwd"],
                      "memvla_train_launches": mem_train["12b_train"]["launches"]["flash_fwd"],
                      "navila_serve_launches": nav["13a_serve"]["launches"]["flash_fwd"],
                      "navila_train_launches": nav["13c_train"]["launches"]["flash_fwd"]},
        "flash_bwd": {"rl_train_launches": sum(r["launches"]["flash_bwd"]
                                               for r in rl_train.values()),
                      "memvla_train_launches": mem_train["12b_train"]["launches"]["flash_bwd"],
                      "navila_train_launches": nav["13c_train"]["launches"]["flash_bwd"]},
        "quant_matmul": {"memvla_int8_launches": mem_q["launches"]["quant_matmul"],
                         "memvla_int8_request_launches": mem_q["k4_per_request"]}}
    oft_counts = {  # each kernel's launches on OFT's three paths: served bf16, int8, trained
        "flash_fwd": (oft["launches"]["flash_fwd"], oft_q["launches"]["flash_fwd"],
                      oft_train["workers"]["launches"]["flash_fwd"]),
        "flash_bwd": (oft["launches"]["flash_bwd"], oft_q["launches"]["flash_bwd"],
                      oft_train["workers"]["launches"]["flash_bwd"]),
        "quant_matmul": (oft["launches"]["quant_matmul"], oft_q["launches"]["quant_matmul"],
                         oft_train["workers"]["launches"]["quant_matmul"])}
    oft_keys = {name: dict(zip(("oft_launches", "oft_int8_launches", "oft_train_launches"), n))
                for name, n in oft_counts.items()}
    flow_keys = {  # each kernel's launches on phase 15's paths, measured
        "flash_fwd": {"pi05_launches": pi05["launches"]["flash_fwd"],
                      "dm0_launches": dm0["launches"]["flash_fwd"],
                      "dm0_prog_launches": dm0["dm0_prog"]["launches"]["flash_fwd"],
                      "pi05_train_launches": flow_train["pi05"]["launches"]["flash_fwd"],
                      "dm0_train_launches": flow_train["dm0"]["launches"]["flash_fwd"],
                      "hybrid_train_launches": hybrid["launches"]["flash_fwd"],
                      "eval_harness_launches": harness["launches"]["flash_fwd"]},
        "flash_bwd": {"pi05_train_launches": flow_train["pi05"]["launches"]["flash_bwd"],
                      "dm0_train_launches": flow_train["dm0"]["launches"]["flash_bwd"],
                      "hybrid_train_launches": hybrid["launches"]["flash_bwd"]},
        "dit_sample": {"eval_harness_launches": harness["launches"]["dit_sample"]}}
    cp, hops = nav["13e_cp"], nav["13f_ring_hops"]
    moe, pp = par["16a_moe"], par["16b_pipeline"]
    parallel_keys = {  # each attention kernel's launches on the ring (13e), MoE (16a) and
        # pipeline (16b) paths, and its rows at their shapes (13f's hops, 16a's layer, 16b's
        # micro-batch)
        name: {"ring_launches": cp["ring"]["launches"][name],
               "moe_launches": moe["kernel"]["launches"][name],
               "pipeline_launches": pp["launches"][name],
               **{f"ring_hop_n{n}": hops[f"n{n}"]["rows"][name] for n in RING_SPLITS},
               "moe_layer": moe["rows"][name], "pipeline_micro": pp["rows"][name]}
        for name in ("flash_fwd", "flash_bwd")}
    kernels = [
        {"name": "flash_fwd", "route": "cuda", "source": "dexbotic_tpu_torch/csrc/flash_fwd.cu",
         "replaces": "dexbotic_tpu/ops/attention.py:86",
         "also_replaces": "dexbotic_tpu/ops/attention.py:165",
         "launches": launches["flash_fwd"], "train_launches": train["launches"]["flash_fwd"],
         "mesh_train_launches": train["7c_mesh"]["launches"]["flash_fwd"],
         "pi0_launches": pi0["launches"], "pi0_train_launches": pi0_train["launches"]["flash_fwd"],
         "launches_fused_preprocess": fused["launches"]["flash_fwd"],
         "launches_replay": replay["launches"]["flash_fwd"],
         "pi0_int8_launches": pi0_q["launches"]["flash_fwd"], **oft_keys["flash_fwd"],
         **rl_keys["flash_fwd"], **engine_keys["flash_fwd"], **flow_keys["flash_fwd"],
         **parallel_keys["flash_fwd"], **k1, **k1_flow, "build": k1_build},
        {"name": "dit_sample", "route": "cuda", "source": "dexbotic_tpu_torch/csrc/dit_sampler.cu",
         "replaces": "dexbotic_tpu/ops/dit_fused.py:58",
         "launches": launches["dit_sample"], "launches_8_frame_request": serve["k2_b8_request"],
         "launches_fused_preprocess": fused["launches"]["dit_sample"],
         "launches_replay": replay["launches"]["dit_sample"], **flow_keys["dit_sample"], **k2,
         "build": k2_build},
        {"name": "dit_sample_int8", "route": "cuda",
         "source": "dexbotic_tpu_torch/csrc/dit_sampler.cu",
         "replaces": "dexbotic_tpu/ops/dit_fused.py:58",
         "launches": launches_q["dit_sample"], "launches_8_frame_request": serve_q["k2_b8_request"],
         **k2q},
        {"name": "flash_bwd", "route": "cuda", "source": "dexbotic_tpu_torch/csrc/flash_bwd.cu",
         "replaces": "dexbotic_tpu/ops/attention.py:565",
         "also_replaces": ["dexbotic_tpu/ops/attention.py:498", "dexbotic_tpu/ops/attention.py:400",
                           "dexbotic_tpu/ops/attention.py:446"],
         "launches": train["launches"]["flash_bwd"],
         "mesh_train_launches": train["7c_mesh"]["launches"]["flash_bwd"],
         "pi0_train_launches": pi0_train["launches"]["flash_bwd"], **oft_keys["flash_bwd"],
         **rl_keys["flash_bwd"], **engine_keys["flash_bwd"], **flow_keys["flash_bwd"],
         **parallel_keys["flash_bwd"], **k3, "build": k3_build},
        {"name": "quant_matmul", "route": "cuda",
         "source": "dexbotic_tpu_torch/csrc/quant_matmul.cu",
         "replaces": "dexbotic_tpu/ops/quant_matmul.py:77",
         "launches": launches_q["quant_matmul"],
         "single_request_launches": serve_q["k4_single_request"],
         "pi0_int8_launches": pi0_q["launches"]["quant_matmul"],
         "pi0_int8_request_launches": pi0_q["k4_per_request"], **oft_keys["quant_matmul"],
         **rl_keys["quant_matmul"], **engine_keys["quant_matmul"], **k4, "build": k4_build},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
