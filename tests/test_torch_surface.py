"""The port's public surface held to the JAX package's.

Both trees are read with ``ast``; neither package is imported.  For each
module of ``dexbotic_tpu/`` with a twin at the same path in
``dexbotic_tpu_torch/``, every public top-level function and class, every
public method (a name without a leading underscore, or a dunder such as
``__len__``), every parameter name of those and every dataclass field must
exist in the twin, or be named by an entry of the allow-lists below, each
with its reason.  A class's methods and fields in the port include those of
its bases.  A JAX module with no twin must be in ``NO_TWIN``.

So a name the JAX package gains fails here until the port has it or an
entry says why it need not.  An entry that no longer matches a difference
fails too, and no entry may name an option that the port has ported
(``PORTED``).
"""

import ast
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(ROOT, "dexbotic_tpu")
PORT_ROOT = os.path.join(ROOT, "dexbotic_tpu_torch")

# JAX modules with no twin, with ROADMAP Queue 1's reasons
NO_TWIN = {
    "exp/utils.py": "nothing in the JAX package calls it (a comment at exp/trainer.py:309)",
    "ops/masks.py": "dense masks that only tests/test_ops.py uses",
    "utils/profiling.py": "wraps jax.profiler; the port measures with torch.profiler",
    "utils/tree.py": "nothing in the JAX package calls it (a comment at exp/trainer.py:309)",
}

# parameter names that carry JAX's state or XLA's settings: allowed in every signature
JAX_ONLY_PARAMS = {
    "params": "a pytree of weights: the port's functions take the nn.Module",
    "p": "one layer's weights as a dict: the port takes the layer's nn.Module",
    "rng": "a jax.random key: the port takes a torch.Generator, or the caller injects noise",
    "interpret": "Pallas interpret mode: on CPU tensors a port wrapper runs its plain version",
    "sharding": "a jax.sharding placement: the port places tensors on a torch device",
    "data_axis": "a shard_map axis name: the port takes the mesh or its process group",
    "axis_name": "a shard_map axis name: the port takes the process group",
    "unroll": "lax.scan's unroll factor: the port's samplers loop in Python",
    "block_q": "a Pallas tile size: K1 picks its tiles for the card",
    "block_kv": "a Pallas tile size: K1 picks its tiles for the card",
    "single_block_max": "the Pallas kernel's one-block threshold: K1 picks its tiles",
}

# top-level functions that build a weight pytree: the port builds an nn.Module
# (a constructor or build_*) and initialises it in place (init_*_)
INIT_FUNCTION = re.compile(r"^init_\w+$|^\w+_init$")

# one difference each: "module:name" (a function, class or method),
# "module:name(param)" or "module:Class.field"
ALLOWED = {
    "nn/core.py:linear": "a layer is an nn.Module: nn/core.Linear and QuantLinear",
    "nn/core.py:gated_mlp": "a layer is an nn.Module: nn/core.GatedMLP",
    "nn/core.py:mlp": "a layer is an nn.Module: nn/core.MLP",
    "models/oft.py:mlp_resnet": "a layer is an nn.Module: models/oft.MLPResNet",
    "models/oft.py:proprio_projector": "a layer is an nn.Module: models/oft._Projector2",
    "nn/transformer.py:Stream.params": "Stream.module, the decoder's nn.Module",
    "models/dit.py:dit_forward(drop_rng)": "drop_gen, a torch.Generator",
    "ops/dit_fused.py:fused_dit_sample(dit_cfg)": "named cfg, as in models/dit.py",
    "nn/transformer.py:transformer_forward(cache)":
        "the cacheless form; a cached call is mot_forward([Stream(...)], cache=...)",
    "nn/transformer.py:transformer_forward(update_cache)":
        "the cacheless form; a cached call is mot_forward(..., update_cache=True)",
    "exp/optim.py:param_group_labels": "a pytree of labels: a parameter's group is "
                                       "exp/optim.group_of(name)",
    "exp/optim.py:build_optimizer": "an optax transformation: exp/optim.Optimizer",
    "exp/rl/rl_trainer.py:GRPOUpdater.shard_params":
        "GRPOUpdater shards the model in its constructor (parallel/mesh.shard_model)",
    "ops/quant.py:quantize_params": "a pytree transform: ops/quant.quantize_model_ "
                                    "quantizes the module in place",
    "ops/quant.py:quantize_weight(axis)": "quantize_weight(w, dim) on a tensor",
    "ops/quant.py:quantize_weight(pad_cols)":
        "the TPU's 128-lane column padding: K4 masks the ragged edge, so nothing pads",
    "ops/quant.py:dequantize_weight(d)": "dequantize_weight(q, s) on tensors, not a dict",
    "ops/quant.py:is_quantized(leaf)": "is_quantized(module): a pytree leaf is a module",
    "ops/quant.py:quantized_bytes(tree)": "quantized_bytes(model)",
    "ops/quant_matmul.py:quant_matmul_eligible(Np)":
        "quant_matmul_eligible(M, K, N): K4 masks the ragged edge, so N is not padded",
    "ops/quant_matmul.py:quant_matmul_eligible(itemsize)":
        "the TPU's VMEM budget: K4's rule is one of the shape (_MAX_M)",
    "parallel/mesh.py:make_mesh(devices)":
        "the mesh covers the torch.distributed group's processes, one device each",
    "parallel/mesh.py:fsdp_param_specs(mesh)": "fsdp_param_specs(shapes, data): the data "
                                               "axis's size",
    "parallel/mesh.py:replicated": "a NamedSharding: a tensor outside FSDP2 is whole on "
                                   "every rank",
    "parallel/mesh.py:fsdp_shardings": "NamedShardings: parallel/mesh.shard_model lays the "
                                       "module out with FSDP2",
    "parallel/mesh.py:shard_params": "parallel/mesh.shard_model",
    "parallel/mesh.py:tp_fsdp_param_specs": "parallel/mesh.tp_plan with shard_model",
    "parallel/mesh.py:tp_fsdp_shardings": "parallel/mesh.tp_plan with shard_model",
    "parallel/pipeline.py:pipeline_mot_forward(stream_params)":
        "modules, the streams' nn.Modules",
    "data/loader.py:DataLoader.__init__(drop_last)": "no caller in the port sets it",
    "data/loader.py:DataLoader.__init__(epochs)": "no caller in the port sets it",
    "data/loader.py:DataLoader.__init__(prefetch_batches)":
        "no caller in the port sets it: the module constant PREFETCH_BATCHES",
    "data/loader.py:device_prefetch(size)":
        "no caller in the port sets it: the module constant PREFETCH_BATCHES",
    "exp/base_exp.py:TokenizerConfig.use_special_tokens": "no caller in the port sets it",
    "exp/base_exp.py:DataConfig.seed": "no caller in the port sets it",
    "exp/base_exp.py:TokenizerConfig.add_special_tokens": "no caller in the JAX package",
    "ops/attention.py:causal_attention": "no caller in the JAX package",
}

# the options the port took over last; no allow-list entry may name one
PORTED = [
    "exp/serve.py:ActionServer.__init__(save_image_dir)",
    "data/loader.py:DataLoader.__len__",
]


def _public(name: str) -> bool:
    return not name.startswith("_") or (name.startswith("__") and name.endswith("__"))


def _params(fn) -> list:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return [n for n in names if n not in ("self", "cls")]


def _is_dataclass(node: ast.ClassDef) -> bool:
    for d in node.decorator_list:
        f = d.func if isinstance(d, ast.Call) else d
        if getattr(f, "id", None) == "dataclass" or getattr(f, "attr", None) == "dataclass":
            return True
    return False


def _surface(path: str) -> dict:
    """Top-level functions {name: params} and classes {name: (methods, fields, bases)}."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    funcs, classes = {}, {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            funcs[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef):
            methods = {b.name: _params(b) for b in node.body
                       if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef))}
            fields = [b.target.id for b in node.body if isinstance(b, ast.AnnAssign)
                      and isinstance(b.target, ast.Name)] if _is_dataclass(node) else []
            bases = [ast.unparse(b).split(".")[-1] for b in node.bases]
            classes[node.name] = (methods, fields, bases)
    return {"funcs": funcs, "classes": classes}


def _modules(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(d, f)
                out[os.path.relpath(path, root).replace(os.sep, "/")] = path
    return out


JAX_MODULES = _modules(JAX_ROOT)
PORT_MODULES = _modules(PORT_ROOT)
PORT_SURFACE = {rel: _surface(path) for rel, path in PORT_MODULES.items()}
PORT_CLASSES = {}  # a base class named in another module of the port
for _s in PORT_SURFACE.values():
    for _name, _cls in _s["classes"].items():
        PORT_CLASSES.setdefault(_name, _cls)


def _resolved(cls, own: dict, seen=()) -> tuple:
    """A port class's methods and fields with those of its bases."""
    methods, fields, bases = dict(cls[0]), list(cls[1]), cls[2]
    for b in bases:
        base = own.get(b) or PORT_CLASSES.get(b)
        if base is None or b in seen:
            continue
        bm, bf = _resolved(base, own, seen + (b,))
        for k, v in bm.items():
            methods.setdefault(k, v)
        fields = bf + [f for f in fields if f not in bf]
    return methods, fields


def differences(rel: str) -> list:
    """What the JAX module ``rel`` has and its twin lacks, as allow-list keys
    with the parameter name apart: [(key, param or None)]."""
    jax, port = _surface(JAX_MODULES[rel]), PORT_SURFACE[rel]
    out = []

    def params(key, want, have):
        out.extend((f"{key}({p})", p) for p in want if p not in have)

    for name, want in jax["funcs"].items():
        if not _public(name):
            continue
        if name not in port["funcs"]:
            out.append((f"{rel}:{name}", None))
        else:
            params(f"{rel}:{name}", want, port["funcs"][name])
    for name, (methods, fields, _) in jax["classes"].items():
        if not _public(name):
            continue
        if name not in port["classes"]:
            out.append((f"{rel}:{name}", None))
            continue
        have_methods, have_fields = _resolved(port["classes"][name], port["classes"])
        for m, want in methods.items():
            if not _public(m):
                continue
            if m not in have_methods:
                out.append((f"{rel}:{name}.{m}", None))
            else:
                params(f"{rel}:{name}.{m}", want, have_methods[m])
        out.extend((f"{rel}:{name}.{f}", None) for f in fields if f not in have_fields)
    return out


def allowed_by(key: str, param) -> str | None:
    """The allow-list entry that covers one difference, or None."""
    if key in ALLOWED:
        return key
    if param is not None and param in JAX_ONLY_PARAMS:
        return f"param {param}"
    name = key.split(":", 1)[1]
    if param is None and "." not in name and INIT_FUNCTION.match(name):
        return "init function"
    return None


TWINNED = sorted(rel for rel in JAX_MODULES if rel in PORT_MODULES)


@pytest.mark.parametrize("rel", TWINNED)
def test_twin_has_the_jax_modules_surface(rel):
    missing = [key for key, param in differences(rel) if allowed_by(key, param) is None]
    assert not missing, (f"dexbotic_tpu_torch/{rel} lacks {missing}: port them, or add an "
                         f"entry with its reason to this file's allow-lists")


def test_modules_without_a_twin_are_listed():
    assert sorted(rel for rel in JAX_MODULES if rel not in PORT_MODULES) == sorted(NO_TWIN)
    assert all(NO_TWIN.values())


def test_every_allow_list_entry_covers_a_difference():
    used = {allowed_by(key, param) for rel in TWINNED for key, param in differences(rel)}
    want = set(ALLOWED) | {f"param {p}" for p in JAX_ONLY_PARAMS} | {"init function"}
    assert not want - used, f"entries that cover nothing: {sorted(want - used)}"
    assert all(ALLOWED.values()) and all(JAX_ONLY_PARAMS.values())


@pytest.mark.parametrize("option", PORTED)
def test_ported_option_is_in_both_surfaces_and_no_entry(option):
    """Each option is on the JAX side, is not a difference (the twin has it)
    and no entry would cover it if it were."""
    rel, name = option.split(":", 1)
    m = re.match(r"^([\w.]+?)(?:\((\w+)\))?$", name)
    qual, param = m.group(1), m.group(2)
    jax = _surface(JAX_MODULES[rel])
    owner, _, member = qual.partition(".")
    if member:
        methods, fields, _ = jax["classes"][owner]
        assert member in fields or member in methods, option
        if param:
            assert param in methods[member], option
    else:
        assert (owner in jax["funcs"] and (param is None or param in jax["funcs"][owner])), option
    assert option not in {key for key, _ in differences(rel)}, f"the port lacks {option}"
    assert allowed_by(option, param) is None, f"an allow-list entry covers {option}"
