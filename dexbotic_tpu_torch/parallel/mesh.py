"""Device mesh, the FSDP rule and tensor parallelism (port of dexbotic_tpu/parallel/mesh.py).

The JAX package lays a ('data', 'model') mesh over its devices and lets
GSPMD shard parameters (fully sharded along 'data', the ZeRO-3 analogue)
and the batch (its rows along 'data').  Here the mesh is a
``torch.distributed`` ``DeviceMesh`` of the same axes, one process a card:

* the batch: each data rank computes on its contiguous rows of the global
  batch (:func:`batch_sharding`); ranks along 'model' hold the same rows;
* tensor parallelism: :data:`TP_PLAN`, ``parallelize_module`` over every
  decoder (``nn/transformer.Transformer``) on the 'model' axis;
* data parallelism: FSDP2's ``fully_shard`` on the 'data' axis over the
  leaves :func:`fsdp_param_specs` shards, placed on the axis it picks
  (``shard_placement_fn``).

Each decoder layer is an FSDP2 group of its own: gathered around its call
and freed after it, in the forward and again in the backward, where its
gradients are reduce-scattered once complete.  So a rank holds its shards of
the weights, gradients and moments, and one layer's whole weights and
gradients at a time (a neighbour's too while FSDP2 prefetches it), as the
JAX package's gather-on-use does.  FSDP2 refuses a group that mixes
parameter dtypes, and the trainer's dtype rule (bf16 matrices, fp32
vectors, no fp32 master copy) gives exactly that mix: a layer's group takes
the dtype of most of its sharded elements, and the rest of the model
(embeddings, heads, towers, which the model's code also reaches outside
module calls) forms one group a dtype around the whole loss call
(:class:`ShardedModel`), gathered for the step.  A leaf the rule replicates
(below ``min_size``, with no axis divisible by the data size, or any leaf at
data size 1), and a layer's sharded leaf of the other dtype, stays a plain
tensor on every rank, outside every group, and its gradient is averaged
over the data ranks by :meth:`ShardedModel.reduce_replicated_grads` (one
collective a dtype).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch import nn

MESH_AXES = ("data", "model")
FSDP_MIN_SIZE = 2 ** 14  # the JAX rule's: smaller leaves are replicated

# the JAX TP_RULES over the port's parameter names: (module name suffix,
# style).  q/k/v and gate/up are column-parallel (their output features),
# o and down row-parallel (their input features), the embedding table on its
# hidden axis and the LM head on its vocabulary, both gathered whole at
# their outputs.
TP_PLAN = (
    ("attn.q", "colwise"),
    ("attn.k", "colwise"),
    ("attn.v", "colwise"),
    ("attn.o", "rowwise"),
    ("mlp.gate", "colwise"),
    ("mlp.up", "colwise"),
    ("mlp.down", "rowwise"),
    ("embed", "colwise_gathered"),
    ("lm_head", "colwise_gathered"),
)


def make_mesh(data: Optional[int] = None, model: int = 1, expert: int = 1,
              device_type: Optional[str] = None):
    """The ('data', 'model') ``DeviceMesh`` over every process of the group.

    ``data`` defaults to the processes left over by ``model``; the mesh must
    cover the group exactly.  An expert axis is ROADMAP item 11c."""
    from torch.distributed.device_mesh import init_device_mesh

    if expert > 1:
        raise NotImplementedError("an 'expert' mesh axis (MoE expert parallelism) is not "
                                  "ported yet: ROADMAP Queue 1 item 11c")
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs a process group: launch with torchrun, or set "
                           "DEXBOTIC_COORDINATOR / DEXBOTIC_NUM_PROCESSES / "
                           "DEXBOTIC_PROCESS_ID (parallel/multihost.maybe_initialize)")
    n = dist.get_world_size()
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data} x {model} needs {data * model} processes, the group has {n}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (data, model), mesh_dim_names=MESH_AXES)


def mesh_shape(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def batch_sharding(mesh) -> tuple[int, int]:
    """(this rank's data coordinate, the data size): the rank takes rows
    ``[i * n / size, (i + 1) * n / size)`` of a global batch of n rows."""
    return mesh.get_local_rank("data"), mesh_shape(mesh)["data"]


def fsdp_param_specs(shapes: dict, data: int, min_size: int = FSDP_MIN_SIZE) -> dict:
    """{name: the axis sharded over 'data', or None to replicate} for
    ``shapes`` ({name: shape}): the JAX rule, a pure function of shapes.

    A leaf is sharded along its largest axis divisible by ``data`` (the
    first of equal ones); a 0-d leaf, one under ``min_size`` elements, one
    with no divisible axis, or any leaf at ``data == 1``, is replicated.
    Torch stores a linear's weight [out, in] where JAX stores [in, out], so
    a square weight shards its other axis: that changes no number."""
    out = {}
    for name, shape in shapes.items():
        shape = tuple(shape)
        size = 1
        for s in shape:
            size *= s
        axis = None
        if shape and size >= min_size and data > 1:
            for a in sorted(range(len(shape)), key=lambda a: -shape[a]):
                if shape[a] % data == 0:
                    axis = a
                    break
        out[name] = axis
    return out


def _tp_style(kind: str):
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.parallel import ColwiseParallel, RowwiseParallel

    if kind == "colwise":
        return ColwiseParallel()
    if kind == "rowwise":
        return RowwiseParallel()
    return ColwiseParallel(output_layouts=Replicate())


def tp_plan(model: nn.Module, model_size: int) -> dict:
    """{module name: ParallelStyle} of :data:`TP_PLAN` over every decoder in
    ``model``.  A decoder whose head counts the model size does not divide
    is refused."""
    from dexbotic_tpu_torch.nn.transformer import Transformer

    plan = {}
    for prefix, mod in model.named_modules():
        if not isinstance(mod, Transformer):
            continue
        cfg = getattr(mod, "cfg", None)
        heads = (cfg.num_heads, cfg.num_kv_heads) if cfg is not None else None
        if heads is not None and any(h % model_size for h in heads):
            raise ValueError(f"tensor parallelism over {model_size} ranks needs num_heads and "
                             f"num_kv_heads divisible by it; {prefix or 'the decoder'} has "
                             f"{heads[0]} and {heads[1]}")
        for name, sub in mod.named_modules():
            for suffix, kind in TP_PLAN:
                if (name == suffix or name.endswith("." + suffix)) and isinstance(
                        sub, (nn.Linear, nn.Embedding)):
                    plan[f"{prefix}.{name}" if prefix else name] = _tp_style(kind)
    return plan


class _Call(nn.Module):
    """``fn(model, *args)`` as a module call, so that FSDP2's hooks run around it."""

    def __init__(self, inner: nn.Module):
        super().__init__()
        self.inner = inner

    def forward(self, fn: Callable, *args):
        if isinstance(self.inner, _Call):
            return self.inner(fn, *args)
        return fn(self.inner, *args)


class ShardedModel:
    """A model laid out over a mesh by :func:`shard_model`.

    ``__call__(fn, *args)`` runs ``fn(model, *args)`` (the step's loss)
    through the whole-model groups; :meth:`reduce_replicated_grads`
    averages the replicated leaves' gradients over the data ranks after the
    backward."""

    def __init__(self, model: nn.Module, mesh, call: nn.Module, groups: dict, layers: dict,
                 replicated: list):
        self.model = model
        self.mesh = mesh
        self.call = call
        self.groups = groups  # dtype -> [parameter names] of a whole-model group
        self.layers = layers  # decoder layer's module name -> [parameter names] of its group
        self.replicated = replicated  # names of the leaves outside every group
        self.data_rank, self.data_size = batch_sharding(mesh)
        self.data_group = mesh.get_group("data")

    def __call__(self, fn: Callable, *args):
        return self.call(fn, *args)

    def _whole_model_groups(self) -> list:
        from torch.distributed.fsdp import FSDPModule

        return [m for m in self.call.modules() if isinstance(m, _Call) and isinstance(m, FSDPModule)]

    @contextlib.contextmanager
    def gathered(self):
        """The model, runnable outside the step's loss call (RL rollouts, a
        probe): the whole-model groups are gathered inside the block, and
        each decoder layer gathers its own group around its call."""
        groups = self._whole_model_groups()
        for m in groups:
            m.unshard()
        try:
            yield self.model
        finally:
            for m in groups:
                m.reshard()

    @torch.no_grad()
    def reduce_replicated_grads(self) -> None:
        """The replicated leaves' gradients, averaged over the data ranks in
        place: one all-reduce a dtype over their concatenation (a leaf the
        loss did not reach takes zeros; under tensor parallelism a leaf's
        local shard).  One data rank: nothing to average."""
        from dexbotic_tpu_torch.exp.optim import local

        if self.data_size == 1:
            return
        params = dict(self.model.named_parameters())
        by_dtype: dict = {}
        for name in self.replicated:
            p = params[name]
            if p.requires_grad:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                by_dtype.setdefault(p.dtype, []).append(local(p.grad))
        for grads in by_dtype.values():
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=self.data_group)
            flat.div_(self.data_size)
            offset = 0
            for g in grads:
                g.copy_(flat[offset: offset + g.numel()].view_as(g))
                offset += g.numel()


def mesh_requested(data: Optional[int], model: int) -> bool:
    """Whether a run takes the mesh path: a process group is up, or the
    configured mesh asks for more than one process."""
    return dist.is_initialized() or (data or 1) > 1 or model > 1


def _fully_shard(module: nn.Module, dp_mesh, keep: dict, axes: dict, reshard: bool) -> None:
    """FSDP2 over the leaves ``keep`` ({parameter: name}) of ``module``,
    each on the axis ``axes`` gives it; its other leaves are left alone."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import DTensor, Shard

    ids = {id(p): n for p, n in keep.items()}

    def place(param):
        name = ids.get(id(param))
        if name is None or isinstance(param, DTensor):
            return None  # FSDP2's default, dim 0
        return Shard(axes[name])

    ignored = {p for p in module.parameters() if id(p) not in ids}
    fully_shard(module, mesh=dp_mesh, shard_placement_fn=place, ignored_params=ignored,
                reshard_after_forward=reshard)


def shard_model(model: nn.Module, mesh) -> ShardedModel:
    """Tensor parallelism on 'model' (:func:`tp_plan`), then FSDP2 on 'data'
    over the leaves :func:`fsdp_param_specs` shards.

    Each decoder layer (``nn/transformer.DecoderLayer``) is a group of its
    own, gathered around its call and freed after it, in the forward and
    again in the backward, where its gradients are reduce-scattered as soon
    as they are complete: a rank holds its shards and one layer's whole
    weights and gradients at a time.  A group takes one dtype (FSDP2 refuses
    a mix), so a layer's group holds the dtype of most of its sharded
    elements (the bf16 matrices under the trainer's dtype rule), and a
    sharded leaf of another dtype in the layer is replicated instead.  The
    rest of the model (embeddings, heads, towers) forms one group a dtype
    around the whole loss call, since it reaches parameters outside module
    calls.  At data size 1 every leaf is replicated, as the JAX rule says,
    and no group is made."""
    from dexbotic_tpu_torch.nn.transformer import DecoderLayer

    sizes = mesh_shape(mesh)
    data, model_size = sizes["data"], sizes["model"]
    if model_size > 1:
        from torch.distributed.tensor.parallel import parallelize_module

        parallelize_module(model, mesh["model"], tp_plan(model, model_size))
    named = dict(model.named_parameters())
    axes = fsdp_param_specs({n: tuple(p.shape) for n, p in named.items()}, data, FSDP_MIN_SIZE)
    sharded = {n for n, a in axes.items() if a is not None}
    dp_mesh = mesh["data"]

    layers: dict = {}
    for prefix, mod in model.named_modules():
        if not isinstance(mod, DecoderLayer):
            continue
        mine = {f"{prefix}.{n}": p for n, p in mod.named_parameters()}
        size: dict = {}
        for n in sorted(sharded & set(mine)):
            size[mine[n].dtype] = size.get(mine[n].dtype, 0) + mine[n].numel()
        if not size:
            continue
        dtype = max(size, key=size.get)
        keep = {p: n for n, p in mine.items() if n in sharded and p.dtype == dtype}
        _fully_shard(mod, dp_mesh, keep, axes, reshard=True)
        layers[prefix] = sorted(keep.values())
        sharded -= set(mine)  # the layer's other leaves are replicated

    groups: dict = {}
    for name, p in named.items():  # in the model's order, the same on every rank
        if name in sharded:
            groups.setdefault(p.dtype, []).append(name)
    grouped = {n for names in list(groups.values()) + list(layers.values()) for n in names}
    replicated = [n for n in named if n not in grouped]

    call: nn.Module = _Call(model)
    if groups or layers:
        # FSDP2 takes the first module called as the root of every group: a
        # whole-model group (or one holding no leaf) around the loss call
        for _ in range(max(len(groups), 1) - 1):
            call = _Call(call)
        level = call
        for names in (groups.values() if groups else [[]]):
            _fully_shard(level, dp_mesh, {named[n]: n for n in names}, axes, reshard=False)
            level = level.inner
        with torch.no_grad():  # the root's first call, before any layer's own
            call(lambda model: None)
    out = ShardedModel(model, mesh, call, groups, layers, replicated)
    for m in out._whole_model_groups():
        m.reshard()
    return out
