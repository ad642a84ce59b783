"""Pipeline parallelism: the GPipe schedule over a 'stage' mesh axis (port
of dexbotic_tpu/parallel/pipeline.py).

A stage owns a contiguous ``L / S`` of the decoder's layers
(:func:`pp_param_shardings`); the batch is cut into ``n_micro``
micro-batches, and stage s runs micro-batch m at tick ``m + s`` of the
``n_micro + S - 1`` ticks, receiving its input from stage s - 1 and sending
its output to stage s + 1.  Only the last stage's outputs are real; they
are broadcast to every stage, so the layers after the pipeline (the final
norm, the LM head, the loss) run replicated, as in the JAX package.  The
MoT streams of the flow VLAs (the prefix through the LLM's layers, the
suffix through the expert's, one joint attention a layer) ride the
pipeline together (:func:`pipeline_mot_forward`).

``torch.distributed``'s send and recv carry no gradient, so the schedule is
one ``autograd.Function`` (:class:`GPipe`): its forward runs the stage's
layers on each micro-batch with the graph kept, and its backward runs the
same ticks in reverse, each micro-batch's gradient received from the next
stage, back-propagated through the stage's layers (their parameters'
gradients accumulate in ``.grad``, as a reentrant checkpoint's do) and sent
to the previous stage.  The inputs' gradients (the embeddings', taken by
stage 0, and the adaRMS conditions', taken by every stage) are summed over
the stages, so every stage holds the whole gradient of each replicated
input.  Call ``.backward()`` on a loss through it (``torch.autograd.grad``
does not see the parameters' gradients).

Data parallelism composes: on a ('stage', 'data') mesh
(``parallel/mesh.make_pipeline_mesh``) each data rank passes its own rows
and means divide by the global batch's counts (``models/losses.data_parallel``).
One stage (``mesh=None`` or a stage axis of one) runs the micro-batches
through every layer with no transfer.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from dexbotic_tpu_torch.models import losses
from dexbotic_tpu_torch.nn.transformer import (
    TransformerConfig,
    _apply_norm,
    embed_tokens,
    lm_logits,
    mot_layer,
)
from dexbotic_tpu_torch.ops.rope import rope_cos_sin

__all__ = ["decoder_layer", "mot_decoder_layer", "GPipe", "pipeline_mot_forward",
           "pipeline_transformer_forward", "lm_loss", "pipeline_causal_lm_loss",
           "pipeline_flow_vla_loss", "pp_param_shardings"]


def mot_decoder_layer(cfgs, lps, xs, cos, sin, grp, valid, seg, conds) -> tuple:
    """One MoT layer over N streams with no cache: the layer of
    ``nn/transformer.mot_forward`` (``mot_layer``).  ``cos``/``sin``/``grp``/
    ``valid``/``seg`` span the concatenation.  An MoE layer routes the
    micro-batch alone, and its balance loss is not returned (the JAX
    pipeline runs dense decoders only)."""
    return mot_layer(cfgs, lps, xs, conds, cos, sin, grp, valid, seg)[0]


def decoder_layer(cfg: TransformerConfig, lp, x, cos, sin, grp, valid, seg=None):
    """One pre-norm decoder layer, the single-stream case of
    :func:`mot_decoder_layer` (a layer of ``transformer_forward``)."""
    return mot_decoder_layer((cfg,), (lp,), (x,), cos, sin, grp, valid, seg, (None,))[0]


class _Stages:
    """This rank's place in the pipeline: S stages over ``group``, stage s."""

    def __init__(self, mesh, stage_axis: str):
        from dexbotic_tpu_torch.parallel.mesh import axis_size

        self.S = 1 if mesh is None else axis_size(mesh, stage_axis)
        self.group = None if self.S == 1 else mesh.get_group(stage_axis)
        self.s = 0 if self.S == 1 else mesh.get_local_rank(stage_axis)

    def peer(self, stage: int) -> int:
        return dist.get_global_rank(self.group, stage)


def _send(tensors, dst: int, group) -> list:
    """The sends' (request, tensor) pairs: a tensor stays alive until its wait."""
    sent = [t.contiguous() for t in tensors]
    return [(dist.isend(t, dst, group), t) for t in sent]


def _recv(likes, src: int, group) -> tuple:
    bufs = [torch.empty_like(t) for t in likes]
    for req in [dist.irecv(b, src, group) for b in bufs]:
        req.wait()
    return tuple(bufs)


class GPipe(torch.autograd.Function):
    """The GPipe schedule of one stage (see the module's docstring).

    ``apply(run, stages, n_micro, n_x, *tensors)``: ``tensors`` are the
    ``n_x`` activation streams [B, ...], taken by stage 0, then the context
    tensors [B, ...] every stage takes (rope tables, masks, conditions);
    ``run(xs, ctx) -> xs`` runs this stage's layers on one micro-batch.
    Returns the last stage's outputs on every stage."""

    @staticmethod
    def forward(ctx, run, stages: _Stages, n_micro: int, n_x: int, *tensors):
        B = tensors[0].shape[0]
        if B % n_micro:
            raise ValueError(f"batch {B} is not divisible by n_micro {n_micro}")
        chunks = [t.chunk(n_micro) if isinstance(t, torch.Tensor) else (t,) * n_micro
                  for t in tensors]
        S, s = stages.S, stages.s
        ctx.stages, ctx.n_micro, ctx.n_x = stages, n_micro, n_x
        ctx.steps, ctx.shapes = [], [c[0] for c in chunks[:n_x]]
        ctx.grad_inputs = [isinstance(t, torch.Tensor) and t.requires_grad for t in tensors]
        outs, sends = [None] * n_micro, []
        for tick in range(n_micro + S - 1):
            m = tick - s
            if not 0 <= m < n_micro:
                continue  # a bubble: no work
            xs = (tuple(c[m] for c in chunks[:n_x]) if s == 0
                  else _recv(ctx.shapes, stages.peer(s - 1), stages.group))
            xs = tuple(x.detach().requires_grad_(x.is_floating_point()) for x in xs)
            cs = tuple(c[m].detach().requires_grad_(g) if isinstance(c[m], torch.Tensor) else c[m]
                       for c, g in zip(chunks[n_x:], ctx.grad_inputs[n_x:]))
            with torch.enable_grad():
                ys = tuple(run(xs, cs))
            ctx.steps.append((xs, cs, ys))
            if s < S - 1:
                sends += _send([y.detach() for y in ys], stages.peer(s + 1), stages.group)
            else:
                outs[m] = tuple(y.detach() for y in ys)
        for req, _ in sends:
            req.wait()
        if S == 1:
            return tuple(torch.cat(parts) for parts in zip(*outs))
        last = stages.peer(S - 1)
        full = (tuple(torch.cat(parts) for parts in zip(*outs)) if s == S - 1
                else tuple(torch.empty((B,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
                           for x in ctx.shapes))
        for t in full:
            dist.broadcast(t, last, group=stages.group)
        return full

    @staticmethod
    def backward(ctx, *grads):
        stages, n_micro, n_x = ctx.stages, ctx.n_micro, ctx.n_x
        S, s = stages.S, stages.s
        g_chunks = [None if g is None else g.chunk(n_micro) for g in grads]
        dxs = [None] * n_micro
        dctx = [None] * n_micro
        sends = []
        for m in reversed(range(n_micro)):  # a stage's steps are its micro-batches in order
            xs, cs, ys = ctx.steps[m]
            if s == S - 1:
                gy = tuple(torch.zeros_like(y) if g is None else g[m]
                           for g, y in zip(g_chunks, ys))
            else:
                gy = _recv(ys, stages.peer(s + 1), stages.group)
            with torch.enable_grad():
                torch.autograd.backward(ys, gy)
            dxs[m] = tuple(torch.zeros_like(x) if x.grad is None else x.grad for x in xs)
            dctx[m] = tuple(c.grad if isinstance(c, torch.Tensor) and c.requires_grad else None
                            for c in cs)
            if s > 0:
                sends += _send(dxs[m], stages.peer(s - 1), stages.group)
        for req, _ in sends:
            req.wait()
        out = []
        for i in range(n_x):
            out.append(torch.cat([d[i] for d in dxs]) if s == 0
                       else torch.zeros((n_micro * ctx.shapes[i].shape[0],)
                                        + tuple(ctx.shapes[i].shape[1:]),
                                        dtype=ctx.shapes[i].dtype, device=ctx.shapes[i].device))
        for j, wanted in enumerate(ctx.grad_inputs[n_x:]):
            out.append(torch.cat([torch.zeros_like(st[1][j]) if d[j] is None else d[j]
                                  for st, d in zip(ctx.steps, dctx)]) if wanted else None)
        if S > 1:  # every stage: the whole gradient of each replicated input
            for t in out:
                if t is not None:
                    dist.all_reduce(t, group=stages.group)
        ctx.steps = None
        return (None, None, None, None) + tuple(out)


def _stage_layers(modules: Sequence, stages: _Stages) -> list:
    """This stage's contiguous L / S layers of each stream, zipped a layer."""
    L = len(modules[0].layers)
    if L % stages.S:
        raise ValueError(f"num_layers {L} is not divisible by {stages.S} stages")
    per = L // stages.S
    lo = stages.s * per
    return list(zip(*(list(m.layers)[lo: lo + per] for m in modules)))


def pipeline_mot_forward(cfgs: Sequence[TransformerConfig], modules: Sequence, embeds: Sequence,
                         positions: torch.Tensor, grp: torch.Tensor, valid: torch.Tensor, mesh,
                         n_micro: int = 4, conds=None, seg: Optional[torch.Tensor] = None,
                         stage_axis: str = "stage") -> list:
    """The MoT (π0 / π0.5 / DM0) forward, GPipe-pipelined over
    ``mesh[stage_axis]``: each stage owns the same contiguous layers of every
    stream (the streams share a depth) and the streams' activations ride
    together.  Equals ``mot_forward`` with no cache; returns the streams'
    final-normed outputs."""
    cfgs = tuple(cfgs)
    base = cfgs[0]
    for c in cfgs:
        if c.num_layers != base.num_layers:
            raise ValueError("MoT streams must share a depth")
    stages = _Stages(mesh, stage_axis)
    layers = _stage_layers(modules, stages)
    conds = tuple(conds) if conds is not None else (None,) * len(cfgs)
    cos, sin = rope_cos_sin(positions, base.head_dim, base.rope_theta)
    grp, valid = grp.to(torch.int32), valid.to(torch.int32)
    seg = None if seg is None else seg.to(torch.int32)
    n_x = len(embeds)

    def run(xs, cs):
        cos_m, sin_m, grp_m, valid_m, seg_m, *conds_m = cs
        for lps in layers:
            xs = mot_decoder_layer(cfgs, lps, xs, cos_m, sin_m, grp_m, valid_m, seg_m, conds_m)
        return xs

    hidden = GPipe.apply(run, stages, n_micro, n_x, *embeds, cos, sin, grp, valid, seg, *conds)
    return [_apply_norm(m.norm, c, x, cond)[0]
            for c, m, x, cond in zip(cfgs, modules, hidden, conds)]


def pipeline_transformer_forward(cfg: TransformerConfig, llm, embeds: torch.Tensor,
                                 positions: torch.Tensor, grp: torch.Tensor, valid: torch.Tensor,
                                 mesh, n_micro: int = 4, seg: Optional[torch.Tensor] = None,
                                 stage_axis: str = "stage") -> torch.Tensor:
    """The decoder stack's forward, GPipe-pipelined: equals
    ``transformer_forward`` (no cache); returns the final-normed hidden
    states [B, T, H] on every stage."""
    return pipeline_mot_forward((cfg,), (llm,), (embeds,), positions, grp, valid, mesh,
                                n_micro=n_micro, seg=seg, stage_axis=stage_axis)[0]


def lm_loss(llm, cfg: TransformerConfig, hidden: torch.Tensor, batch: dict) -> torch.Tensor:
    """The causal-LM loss of final hidden states [B, T, H]: fp32 CE of each
    next token, -100 labels and invalid positions masked, averaged over the
    global batch's targets."""
    valid = batch["attention_mask"].to(torch.int32)
    logits = lm_logits(llm, cfg, hidden[:, :-1]).float()
    labels = batch["labels"][:, 1:]
    mask = (labels != -100) & (valid[:, 1:] == 1)
    safe = torch.where(mask, labels, 0).long()
    nll = -torch.gather(torch.log_softmax(logits, -1), -1, safe[..., None])[..., 0]
    return losses.batch_mean(torch.where(mask, nll, 0.0).sum(), mask.sum(), floor=1)


def pipeline_causal_lm_loss(llm, cfg: TransformerConfig, batch: dict, mesh, n_micro: int = 4,
                            stage_axis: str = "stage") -> torch.Tensor:
    """Causal-LM loss (:func:`lm_loss`) with the decoder stack pipelined: the
    embeddings in bf16 (as the JAX loss), strictly causal groups among the
    valid tokens."""
    valid = batch["attention_mask"].to(torch.int32)
    positions = torch.cumsum(valid, 1, dtype=torch.int32) - 1
    x = embed_tokens(llm, cfg, batch["input_ids"], dtype=torch.bfloat16)
    hidden = pipeline_transformer_forward(cfg, llm, x, positions, positions * valid, valid, mesh,
                                          n_micro=n_micro, stage_axis=stage_axis)
    return lm_loss(llm, cfg, hidden, batch)


def pipeline_flow_vla_loss(model, cfg, batch: dict, mesh, n_micro: int = 4,
                           generator: Optional[torch.Generator] = None,
                           noise: Optional[torch.Tensor] = None,
                           time: Optional[torch.Tensor] = None, stage_axis: str = "stage"):
    """``models/flow_vla.flow_vla_loss`` with the MoT stack pipelined: the
    same embeddings and targets, the two streams through
    :func:`pipeline_mot_forward`; ``noise`` and ``time`` injectable as
    there.  Returns (loss, {"action_loss", "loss"})."""
    from dexbotic_tpu_torch.models.flow_vla import (
        _positions_and_grp,
        embed_prefix,
        embed_suffix,
        sample_flow_time,
    )

    actions = batch["actions"].float()
    B, device = actions.shape[0], actions.device
    if noise is None:
        noise = torch.randn(actions.shape, generator=generator, dtype=torch.float32, device=device)
    if time is None:
        time = sample_flow_time(B, generator, device)
    noise, time = noise.float(), time.float()
    t_exp = time[:, None, None]
    x_t = t_exp * noise + (1 - t_exp) * actions
    u_t = noise - actions
    images = batch["images"]
    image_masks = batch.get("image_masks")
    if image_masks is None:
        image_masks = torch.ones(images.shape[:2], dtype=torch.int32, device=images.device)
    prefix_tokens, prefix_mask, prefix_ar = embed_prefix(
        model, cfg, images, image_masks, batch["input_ids"], batch["attention_mask"])
    states = batch.get("states") if cfg.use_state_token else None
    suffix_tokens, suffix_mask, suffix_ar, cond = embed_suffix(
        model, cfg, states, x_t, time, dtype=prefix_tokens.dtype)
    mask, grp, positions = _positions_and_grp(prefix_mask, prefix_ar, suffix_mask, suffix_ar)
    outs = pipeline_mot_forward((cfg.llm, cfg.expert), (model.vlm.llm, model.expert),
                                (prefix_tokens, suffix_tokens), positions, grp, mask, mesh,
                                n_micro=n_micro, conds=(None, cond) if cfg.adarms else None,
                                stage_axis=stage_axis)
    v_t = model.action_out_proj(outs[1][:, -cfg.chunk_size:])
    loss = (v_t.float() - u_t).square().mean()
    return loss, {"action_loss": loss, "loss": loss}


def pp_param_shardings(model, cfg: TransformerConfig, mesh, stage_axis: str = "stage") -> dict:
    """{parameter name: the stage that holds it, or None (every stage)}: a
    decoder's layers (``layers.<i>.``) split contiguously over the stages,
    everything else replicated, the JAX rule's P('stage') and P()."""
    from dexbotic_tpu_torch.parallel.mesh import axis_size

    S = 1 if mesh is None else axis_size(mesh, stage_axis)
    if cfg.num_layers % S:
        raise ValueError(f"num_layers {cfg.num_layers} is not divisible by {S} stages")
    per = cfg.num_layers // S
    out = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        out[name] = (int(parts[1]) // per if len(parts) > 2 and parts[0] == "layers"
                     and parts[1].isdigit() else None)
    return out
