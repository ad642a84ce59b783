"""Device mesh, the FSDP rule, tensor, context and expert parallelism (port
of dexbotic_tpu/parallel/mesh.py).

The JAX package lays a ('data', 'model') mesh over its devices and lets
GSPMD shard parameters (fully sharded along 'data', the ZeRO-3 analogue)
and the batch (its rows along 'data').  Here the mesh is a
``torch.distributed`` ``DeviceMesh`` of the same axes, one process a card:

* the batch: each data rank computes on its contiguous rows of the global
  batch (:func:`batch_sharding`); ranks along the other axes hold the same
  rows;
* tensor parallelism: :data:`TP_PLAN`, ``parallelize_module`` over every
  decoder (``nn/transformer.Transformer``) on the 'model' axis;
* data parallelism: FSDP2's ``fully_shard`` on the 'data' axis over the
  leaves :func:`fsdp_param_specs` shards, placed on the axis it picks
  (``shard_placement_fn``);
* context parallelism: a ('data', 'model', 'seq') mesh (``make_mesh(seq=)``,
  NaVILA's packed training): each seq rank takes its contiguous columns of
  its data rank's rows, attention is a ring over the axis
  (``parallel/ring.py``, ``attn_impl="ring:seq"``), and parameter
  gradients are summed over it;
* expert parallelism: a ('data', 'expert', 'model') mesh
  (``make_mesh(expert=)``): every MoE expert stack (``nn/moe.py``) is a
  DTensor sharded on its expert axis over 'expert', so a rank holds E /
  expert experts, at rest and through the optimizer's updates (its moments
  are the local shards); the tokens are the data rank's, on every expert
  rank, and the MoE layer runs each expert on its owner;
* pipeline stages: a ('stage', 'data') mesh (:func:`make_pipeline_mesh`,
  ``parallel/pipeline.py``).

The last mesh made is the current one, until ``multihost.shutdown``: where
an axis is named by a string alone (``attention(impl="ring:seq")`` with no
group, :func:`axis_group`) its process group is the current mesh's.  A
caller that holds its mesh passes the group down instead
(``transformer_forward(attn_group=...)``), so that a mesh made later does
not move its ring.

Each decoder layer is an FSDP2 group of its own: gathered around its call
and freed after it, in the forward and again in the backward, where its
gradients are reduce-scattered once complete.  So a rank holds its shards of
the weights, gradients and moments, and one layer's whole weights and
gradients at a time (a neighbour's too while FSDP2 prefetches it), as the
JAX package's gather-on-use does.  FSDP2 refuses a group that mixes
parameter dtypes.  A layer's leaves share one dtype under the trainer's
rule (``nn/core.cast_like_jax_``: the JAX tree stacks the layers, so their
norm scales and biases are bf16 beside the matrices), so a layer's sharded
leaves form its group whole.  The rest of the model (embeddings, heads,
towers, which the model's code also reaches outside module calls) keeps fp32
vectors beside bf16 matrices and forms one group a dtype around the whole
loss call (:class:`ShardedModel`), gathered for the step.  A leaf the rule
replicates (below ``min_size``, with no axis divisible by the data size, or
any leaf at data size 1) and an expert stack under expert parallelism stay
outside every group, and their gradients are averaged over the data ranks
by :meth:`ShardedModel.reduce_grads` (one collective a dtype), which also
sums every gradient over 'seq'.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch import nn

MESH_AXES = ("data", "model")
CP_MESH_AXES = ("data", "model", "seq")
EP_MESH_AXES = ("data", "expert", "model")
PP_MESH_AXES = ("stage", "data")
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


def _require_group() -> int:
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs a process group: launch with torchrun, or set "
                           "DEXBOTIC_COORDINATOR / DEXBOTIC_NUM_PROCESSES / "
                           "DEXBOTIC_PROCESS_ID (parallel/multihost.maybe_initialize)")
    return dist.get_world_size()


_CURRENT = None  # the last mesh made


def _init(device_type: Optional[str], shape: tuple, names: tuple):
    from torch.distributed.device_mesh import init_device_mesh

    global _CURRENT
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    _CURRENT = init_device_mesh(device_type, shape, mesh_dim_names=names)
    return _CURRENT


def make_mesh(data: Optional[int] = None, model: int = 1, expert: int = 1,
              seq: Optional[int] = None, device_type: Optional[str] = None):
    """The ``DeviceMesh`` over every process of the group: ('data',
    'model'); ('data', 'expert', 'model') when ``expert`` > 1 (the JAX
    layout); ('data', 'model', 'seq') when ``seq`` is given (a seq axis of
    one too: NaVILA's context-parallel mesh).

    ``data`` defaults to the processes left over by the other axes; the mesh
    must cover the group exactly.  It becomes the current mesh."""
    n = _require_group()
    if expert > 1 and seq is not None:
        raise ValueError("a mesh has an 'expert' axis or a 'seq' axis, not both")
    rest = model * expert * (seq or 1)
    if data is None:
        data = n // rest
    if data * rest != n:
        raise ValueError(f"mesh {data} x {model} x {expert} x {seq or 1} needs {data * rest} "
                         f"processes, the group has {n}")
    if expert > 1:
        return _init(device_type, (data, expert, model), EP_MESH_AXES)
    if seq is not None:
        return _init(device_type, (data, model, seq), CP_MESH_AXES)
    return _init(device_type, (data, model), MESH_AXES)


def make_pipeline_mesh(stage: int, data: Optional[int] = None,
                       device_type: Optional[str] = None):
    """The ('stage', 'data') ``DeviceMesh`` of GPipe (``parallel/pipeline.py``):
    a stage's ranks hold its layers, each data rank its rows.  It becomes
    the current mesh."""
    n = _require_group()
    if data is None:
        data = n // stage
    if stage * data != n:
        raise ValueError(f"mesh {stage} x {data} needs {stage * data} processes, the group "
                         f"has {n}")
    return _init(device_type, (stage, data), PP_MESH_AXES)


_DATA_PARALLEL = None  # (process group, its size) while a data-parallel step runs


@contextlib.contextmanager
def data_parallel(group, size: int):
    """Means inside the block are over the global batch of ``size`` data
    ranks (``group``), and so are the MoE layers' slots and statistics
    (``nn/moe.py``); every rank must run the same losses in the same order.
    ``models/losses`` reads it (and names it as its own)."""
    global _DATA_PARALLEL
    prev, _DATA_PARALLEL = _DATA_PARALLEL, (group, size)
    try:
        yield
    finally:
        _DATA_PARALLEL = prev


def data_parallel_state():
    """(process group, size) of the data-parallel step running, or None."""
    return _DATA_PARALLEL


def clear_current_mesh() -> None:
    """No current mesh (``multihost.shutdown``: its groups are gone)."""
    global _CURRENT
    _CURRENT = None


def axis_group(name: str):
    """The process group of this rank along axis ``name`` of the current mesh
    (the last one :func:`make_mesh` or :func:`make_pipeline_mesh` made)."""
    mesh = _CURRENT
    if mesh is None:
        raise RuntimeError("no mesh: make one with parallel/mesh.make_mesh")
    if name not in mesh.mesh_dim_names:
        raise ValueError(f"the current mesh has axes {mesh.mesh_dim_names}, not {name!r}")
    return mesh.get_group(name)


def mesh_shape(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axis_size(mesh, name: str) -> int:
    """The size of axis ``name`` of ``mesh`` (1 for an axis it lacks)."""
    return mesh_shape(mesh).get(name, 1)


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
    through the whole-model groups; :meth:`reduce_grads` averages the
    replicated leaves' gradients over the data ranks after the backward, and
    sums every gradient over 'seq'."""

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
    def reduce_grads(self) -> None:
        """After the backward: the replicated leaves' gradients averaged over
        the data ranks in place, one all-reduce a dtype over their
        concatenation (a leaf the loss did not reach takes zeros; under
        tensor or expert parallelism a leaf's local shard); then, on a mesh
        with a 'seq' axis of more than one rank, every gradient summed over
        it, each seq rank holding the gradient of its own columns' share of
        the loss."""
        from dexbotic_tpu_torch.nn.core import local

        seq = axis_size(self.mesh, "seq")
        if self.data_size == 1 and seq == 1:
            return
        params = dict(self.model.named_parameters())
        if self.data_size > 1:
            by_dtype: dict = {}
            for name in self.replicated:
                p = params[name]
                if p.requires_grad:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                    by_dtype.setdefault(p.dtype, []).append(local(p.grad))
            for grads in by_dtype.values():
                _all_reduce_flat(grads, self.data_group, self.data_size)
        if seq > 1:
            by_dtype = {}
            for p in params.values():
                if p.requires_grad:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                    by_dtype.setdefault(p.dtype, []).append(local(p.grad))
            for grads in by_dtype.values():
                _all_reduce_flat(grads, self.mesh.get_group("seq"), 1)


def _all_reduce_flat(grads: list, group, divisor: int) -> None:
    """Sum ``grads`` over ``group`` in place (one collective over their
    concatenation), divided by ``divisor``."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    if divisor != 1:
        flat.div_(divisor)
    offset = 0
    for g in grads:
        g.copy_(flat[offset: offset + g.numel()].view_as(g))
        offset += g.numel()


def mesh_requested(data: Optional[int], model: int) -> bool:
    """Whether a run takes the mesh path: a process group is up, or the
    configured mesh asks for more than one process."""
    return dist.is_initialized() or (data or 1) > 1 or model > 1


def place_experts(model: nn.Module, mesh) -> set:
    """Every MoE expert stack ([E, in, out], ``nn/moe.MoE``) of ``model`` as a
    DTensor sharded on its expert axis over the mesh's 'expert' axis: this
    rank keeps its E / expert experts (no transfer: every rank holds the
    whole stack before).  Returns the stacks' parameter names."""
    from torch.distributed.tensor import DTensor, Shard

    from dexbotic_tpu_torch.nn.moe import MoE

    n = axis_size(mesh, "expert")
    sub = mesh["expert"]
    rank = sub.get_local_rank()
    names = set()
    for prefix, mod in model.named_modules():
        if not isinstance(mod, MoE):
            continue
        if mod.num_experts % n:
            raise ValueError(f"{prefix}: {mod.num_experts} experts over {n} expert ranks")
        for part in ("gate", "up", "down"):
            stack = getattr(mod, part)
            w = stack.weight
            if isinstance(w, DTensor):
                continue
            per = mod.num_experts // n
            shard = w.detach()[rank * per: (rank + 1) * per].clone()
            stack.weight = nn.Parameter(
                DTensor.from_local(shard, sub, [Shard(0)], run_check=False, shape=w.shape,
                                   stride=w.stride()), requires_grad=w.requires_grad)
            names.add(f"{prefix}.{part}.weight")
    return names


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
    a mix), and a layer's leaves share one under the trainer's rule
    (``nn/core.cast_like_jax_``).  The rest of the model (embeddings, heads,
    towers) forms one group a dtype around the whole loss call, since it
    reaches parameters outside module calls.  At data size 1 every leaf is
    replicated, as the JAX rule says, and no group is made.  On a mesh with an 'expert' axis the MoE expert
    stacks are placed first (:func:`place_experts`) and stay outside every
    FSDP2 group."""
    from dexbotic_tpu_torch.nn.transformer import DecoderLayer

    data, model_size = axis_size(mesh, "data"), axis_size(mesh, "model")
    if model_size > 1:
        from torch.distributed.tensor.parallel import parallelize_module

        parallelize_module(model, mesh["model"], tp_plan(model, model_size))
    experts = place_experts(model, mesh) if axis_size(mesh, "expert") > 1 else set()
    named = dict(model.named_parameters())
    axes = fsdp_param_specs({n: tuple(p.shape) for n, p in named.items()}, data, FSDP_MIN_SIZE)
    sharded = {n for n, a in axes.items() if a is not None} - experts
    dp_mesh = mesh["data"]

    layers: dict = {}
    for prefix, mod in model.named_modules():
        if not isinstance(mod, DecoderLayer):
            continue
        mine = {f"{prefix}.{n}": p for n, p in mod.named_parameters()}
        keep = {p: n for n, p in mine.items() if n in sharded}
        if not keep:
            continue
        _fully_shard(mod, dp_mesh, keep, axes, reshard=True)
        layers[prefix] = sorted(keep.values())
        sharded -= set(mine)

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
