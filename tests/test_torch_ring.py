"""Context parallelism in the port: ring attention (``parallel/ring.py``),
NaVILA's context-parallel packed loss and ``NaVILAExp.train()`` with a
'seq' mesh axis, over gloo on the CPU.

Worker processes (``tests/_gloo.py``) run the ring at 2 and 4 processes
(``attention(impl="ring:seq")`` on a ('data', 'model', 'seq') mesh), each on
its contiguous columns; this process holds them:

* against one process (the port's flash attention over the whole
  sequence, the plain versions of K1 and K3) at 1e-5, forward and the
  gradients of sum(out * dO);
* against JAX's ``ring_attention`` under ``shard_map`` on the 8-device
  virtual mesh at 1e-3, on the rows that see a key (a row that sees none is
  0 in the port and a uniform average in JAX; its dO is 0, so the gradients
  compare everywhere);
* in cases with GQA, with no segments, with packed segments and padding,
  and with rows that see no key of several hops (dead hops) or of any.

``navila_packed_loss_cp`` at seq=2 and at data=2 x seq=2 (the model laid
out by ``shard_model``, FSDP2 holding the decoder's matrices over 'data',
the gradients summed over 'seq' by ``reduce_grads``) equals one process's
``navila_packed_loss`` at 1e-5 and JAX's ``navila_packed_loss_cp`` at 1e-3,
loss and every gradient; one ``NaVILAExp.train()`` step at
``context_parallel_seq=2`` equals the one-process step at 1e-5.  The ring
kernels' own check on the card is in ``tests/test_torch_gpu.py``.
"""

import dataclasses
import json
import os
import textwrap

import numpy as np
import pytest
import torch

from _gloo import results, spawn
from dexbotic_tpu_torch.exp import navila_exp as texp
from dexbotic_tpu_torch.exp import optim as toptim
from dexbotic_tpu_torch.exp import trainer as ttrainer
from dexbotic_tpu_torch.models import navila as tnav
from dexbotic_tpu_torch.models import presets as tpresets
from dexbotic_tpu_torch.models import vlm as tvlm
from dexbotic_tpu_torch.nn import vit as tvit
from dexbotic_tpu_torch.ops.attention import _allowed, flash_attention
from dexbotic_tpu_torch.utils.bridge import load_jax_params, port_arrays

try:  # the JAX references; the card's machine has no JAX, and there they skip
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from dexbotic_tpu.models import navila as jnav
    from dexbotic_tpu.models import presets as jpresets
    from dexbotic_tpu.models import vlm as jvlm
    from dexbotic_tpu.nn import vit as jvit
    from dexbotic_tpu.parallel.ring import ring_attention as jring
except ImportError:
    jax = None
needs_jax = pytest.mark.skipif(jax is None, reason="the JAX package is not installed")

EXACT, TOL = 1e-5, 1e-3
VIT = dict(image_size=42, patch_size=14, hidden_size=32, num_layers=2, num_heads=4,
           intermediate_size=64, select_layer=None)
SOFT = np.arange(20, 30, dtype=np.int32)  # the soft CE's numeric tokens
ATTN = {  # name: (B, S, Hq, Hkv, D, kind)
    "packed": (2, 64, 4, 2, 16, "packed"),  # two segments a row, random padding, causal
    "gqa": (2, 64, 8, 2, 16, "none"),  # GQA 4:1, no segments
    "dead": (2, 64, 4, 4, 16, "dead"),  # rows that see no key of many hops, or of any
}


def attn_inputs(name: str) -> dict:
    B, S, Hq, Hkv, D, kind = ATTN[name]
    r = np.random.RandomState(sorted(ATTN).index(name))
    out = {"q": r.randn(B, S, Hq, D), "k": r.randn(B, S, Hkv, D), "v": r.randn(B, S, Hkv, D)}
    grp = np.broadcast_to(np.arange(1, S + 1), (B, S)).copy()
    valid = (r.rand(B, S) > 0.1).astype(np.int32)
    seg = None
    if kind == "packed":
        seg = (np.arange(S)[None] >= r.randint(S // 4, 3 * S // 4, (B, 1))).astype(np.int32)
    elif kind == "dead":  # NaVILA's padding (segment -1) and a row whose start sees nothing
        seg = np.zeros((B, S), np.int32)
        seg[:, 40:] = 1
        seg[:, 56:] = -1
        valid[:, 56:] = 0
        valid[1, :37] = 0
    out.update({k: v.astype(np.float32) for k, v in out.items()})
    out.update(grp=grp.astype(np.int32), valid=valid, seg=seg)
    seen = _allowed(*(torch.from_numpy(x) for x in (grp, grp, valid)),
                    *((None, None) if seg is None else (torch.from_numpy(seg),) * 2))
    out["seen"] = seen[:, 0].any(-1).numpy()  # [B, S]: the row sees a key
    out["dout"] = (r.randn(B, S, Hq, D) * out["seen"][..., None, None]).astype(np.float32)
    return out


RING_WORKER = textwrap.dedent('''
    def _cols(x, n, r):
        return None if x is None else torch.from_numpy(x[:, r * x.shape[1] // n:
                                                           (r + 1) * x.shape[1] // n].copy())


    def case_attention():
        """Every case through attention(impl="ring:seq") on a seq axis of WORLD."""
        from dexbotic_tpu_torch.ops.attention import attention
        from dexbotic_tpu_torch.parallel import ring

        pmesh.make_mesh(data=1, seq=WORLD)
        out = {}
        for name, c in load("attn").items():
            q, k, v = (_cols(c[x], WORLD, RANK).requires_grad_() for x in ("q", "k", "v"))
            g, val, seg = (_cols(c[x], WORLD, RANK) for x in ("grp", "valid", "seg"))
            hops = ring.ring_attention.hops
            o = attention(q, k, v, g, g, val, impl="ring:seq", q_seg=seg, kv_seg=seg)
            (o * _cols(c["dout"], WORLD, RANK)).sum().backward()
            out[name] = {"out": o.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad,
                         "hops": ring.ring_attention.hops - hops}
        save("attn", out)


    def case_cp():
        """navila_packed_loss_cp on a (data, 1, seq) mesh: data 1 at 2
        processes, 2 at 4; each data rank on its own packed rows."""
        save("cp", _cp_step())


    def case_cp_later_mesh():
        """The same step at 4 processes, remat on, after a second mesh whose
        'seq' axis spans every process was made: the loss's mesh decides."""
        save("cp_later_mesh", _cp_step(later=lambda: pmesh.make_mesh(data=1, seq=WORLD),
                                       remat=True))


    def _cp_step(later=None, remat=False):
        from dexbotic_tpu_torch.models import losses
        from dexbotic_tpu_torch.models import navila as tnav

        data = 1 if WORLD == 2 else 2
        pmesh.FSDP_MIN_SIZE = 256  # so that the tiny decoder's matrices shard over 'data'
        mesh = pmesh.make_mesh(data=data, seq=WORLD // data)
        if later is not None:
            later()
        cfg, soft = load("cp_cfg"), torch.from_numpy(load("soft"))
        model = tnav.build_navila(cfg, "cpu")
        model.load_state_dict(load("navila"))
        model.requires_grad_(True)
        sharded = pmesh.shard_model(model, mesh)
        batch = {k: torch.from_numpy(v) for k, v in load(f"cp_batch{data}")[sharded.data_rank].items()}
        with losses.data_parallel(sharded.data_group, data):
            loss, _ = sharded(lambda m, b: tnav.navila_packed_loss_cp(m, cfg, b, mesh, soft,
                                                                      remat=remat), batch)
        loss.backward()
        sharded.reduce_grads()
        grads = {n: multihost.host_copy(p.grad) for n, p in model.named_parameters()
                 if p.grad is not None}
        return {"loss": float(loss), "grads": grads, "fsdp_layers": len(sharded.layers)}


    def case_exp():
        """One NaVILAExp.train() step at context_parallel_seq=2."""
        from dexbotic_tpu_torch.data import registry
        from dexbotic_tpu_torch.exp import navila_exp as texp
        from dexbotic_tpu_torch.exp import optim as toptim
        from dexbotic_tpu_torch.exp import trainer as ttrainer
        from dexbotic_tpu_torch.models import presets as tpresets
        from dexbotic_tpu_torch.nn import vit as tvit

        spec = load("exp")
        tpresets.VIT_PRESETS["navila_test"] = tvit.ViTConfig(**spec["vit"])
        registry.register_dataset(spec["suite"], prefix=spec["prefix"], meta_data={})
        exp = texp.NaVILAExp(
            device="cpu", model=texp.NaVILAModelConfig(**spec["model"], context_parallel_seq=2),
            tokenizer=texp.base_exp.TokenizerConfig(**spec["tokenizer"]),
            data=texp.NaVILADataConfig(**spec["data"]))
        exp.trainer = ttrainer.TrainerConfig(output_dir=os.path.join(OUT, "exp"), **spec["trainer"])
        exp.optimizer = toptim.OptimizerConfig(**spec["optimizer"])
        exp.train()
''')


def _cfg():
    return tnav.NaVILAConfig(vlm=tvlm.VLMConfig(llm=tpresets.LLM_TEST, vit=tvit.ViTConfig(**VIT),
                                                projector_type="mlp_downsample"),
                             num_video_frames=2, use_soft_ce=True)


def _samples(seed: int, lens: list, nt: int, frames: int = 2):
    """Right-padded samples: nt image slots, then text of ``lens`` tokens,
    labels on all but the first two text tokens."""
    from dexbotic_tpu_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX

    rs = np.random.RandomState(seed)
    B, L = len(lens), nt + max(lens)
    ids = np.zeros((B, L), np.int64)
    labels = np.full((B, L), IGNORE_INDEX, np.int64)
    valid = np.zeros((B, L), np.int64)
    for i, tl in enumerate(lens):
        ids[i, :nt] = IMAGE_TOKEN_INDEX
        ids[i, nt: nt + tl] = rs.randint(1, 400, tl)
        valid[i, : nt + tl] = 1
        labels[i, nt + 2: nt + tl] = ids[i, nt + 2: nt + tl]
    return ids, labels, valid, rs.randn(B, frames, 42, 42, 3).astype(np.float32)


def _cp_batches(cfg, data: int) -> tuple:
    """(one packed batch a data rank, the global batch): each rank packs its
    own 4 samples into 2 rows of 2 * max_len (divisible by 4); the global
    batch is their rows, with rank 1's image rows after rank 0's."""
    nt = cfg.vlm.num_image_tokens * 2
    per, width = [], 2 * (nt + 12)
    for d in range(data):
        ids, labels, valid, imgs = _samples(2 + d, [12, 9, 6, 4], nt)
        packed = tnav.pack_batch(ids, labels, valid, num_rows=2, max_len=width)
        packed["images"] = imgs
        per.append(packed)
    glob = {k: np.concatenate([p[k] for p in per]) for k in per[0]}
    offset = 0
    for d, p in enumerate(per):
        glob["img_index"][2 * d: 2 * d + 2] = p["img_index"] + offset
        offset += len(p["images"]) * nt
    return per, glob


def _write_suite(root: str) -> dict:
    """A 3-episode navigation suite of 28x28 frames; its registry entry."""
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    answers = ["The next action is move forward 50 cm.", "The next action is turn left 30 degree.",
               "The next action is stop.", "The next action is turn right 15 degree."]
    for e, n in enumerate((11, 4, 7)):
        lines = []
        for t in range(n):
            Image.new("RGB", (30, 26), (e * 70, t * 9, 40)).save(f"{root}/e{e}f{t}.png")
            lines.append(json.dumps({"images_1": {"type": "image", "url": f"e{e}f{t}.png"},
                                     "prompt": "walk to the kitchen" + " and stop" * (t % 3),
                                     "answer": answers[(e + t) % 4]}))
        with open(f"{root}/e{e}.jsonl", "w") as f:
            f.write("\n".join(lines))
    return {"suite": {"data_path_prefix": root, "annotations": root, "frequency": 1}}


EXP = {"model": dict(llm_preset="test", vit_preset="navila_test", pack_max_len=640),
       "tokenizer": dict(model_max_length=512),
       "data": dict(dataset_name="navcp_suite", image_processor="42", num_images=8,
                    data_keys=["input_ids", "labels", "image"])}
EXP_TRAINER = dict(max_steps=1, per_device_batch_size=2, logging_steps=1, save_steps=1,
                   bf16=False, resume=False, gradient_checkpointing=True, seed=3)
EXP_OPT = dict(learning_rate=1e-4, freeze_llm=False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Inputs, the worker runs at 2 and 4 processes, and the one-process
    references of the port (this process)."""
    from dexbotic_tpu_torch.data import registry

    tmp = tmp_path_factory.mktemp("ring")
    (tmp / "in").mkdir()
    attn = {name: attn_inputs(name) for name in ATTN}
    torch.save(attn, tmp / "in" / "attn.pt")
    cfg = _cfg()
    model = tnav.build_navila(cfg, "cpu", seed=5)
    params = None
    if jax is not None:  # the JAX init, bridged, so that the JAX references start from it
        jcfg = jnav.NaVILAConfig(vlm=jvlm.VLMConfig(llm=jpresets.LLM_TEST,
                                                    vit=jvit.ViTConfig(**VIT),
                                                    projector_type="mlp_downsample"),
                                 num_video_frames=2, use_soft_ce=True)
        params = jax.device_get(jnav.init_navila(jax.random.PRNGKey(0), jcfg))
        load_jax_params(model, params)
    torch.save(model.state_dict(), tmp / "in" / "navila.pt")
    torch.save(cfg, tmp / "in" / "cp_cfg.pt")
    torch.save(SOFT, tmp / "in" / "soft.pt")
    globs = {}
    for data in (1, 2):
        per, globs[data] = _cp_batches(cfg, data)
        torch.save(per, tmp / "in" / f"cp_batch{data}.pt")
    suite = _write_suite(str(tmp / "nav"))
    torch.save({"vit": VIT, "suite": suite, "prefix": "navcp", **EXP, "trainer": EXP_TRAINER,
                "optimizer": EXP_OPT}, tmp / "in" / "exp.pt")

    spawn(tmp, 2, RING_WORKER, ["attention", "cp", "exp"])
    got = {2: {"attn": results(tmp, "attn", 2), "cp": results(tmp, "cp", 2)}}
    spawn(tmp, 4, RING_WORKER, ["attention", "cp", "cp_later_mesh"])
    got[4] = {k: results(tmp, k, 4) for k in ("attn", "cp", "cp_later_mesh")}

    # one process: the whole sequence through the port's flash attention
    ref_attn = {}
    for name, c in attn.items():
        q, k, v = (torch.from_numpy(c[x]).requires_grad_() for x in ("q", "k", "v"))
        ints = [None if c[x] is None else torch.from_numpy(c[x]) for x in ("grp", "valid", "seg")]
        o = flash_attention(q, k, v, ints[0], ints[0], ints[1], q_seg=ints[2], kv_seg=ints[2])
        (o * torch.from_numpy(c["dout"])).sum().backward()
        ref_attn[name] = {"out": o.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}
    ref_cp = {}
    for data, glob in globs.items():
        model.requires_grad_(True)
        model.zero_grad()
        loss, _ = tnav.navila_packed_loss(model, cfg, {k: torch.from_numpy(v) for k, v in glob.items()},
                                          torch.from_numpy(SOFT))
        loss.backward()
        ref_cp[data] = {"loss": float(loss.detach()), "grads": {n: p.grad.clone() for n, p in
                                                       model.named_parameters()}}
    # one process: the same exp step at context_parallel_seq=1
    tpresets.VIT_PRESETS["navila_test"] = tvit.ViTConfig(**VIT)
    registry.register_dataset(suite, prefix="navcp", meta_data={})
    cwd = os.getcwd()
    try:
        os.chdir(tmp)
        exp = texp.NaVILAExp(device="cpu", model=texp.NaVILAModelConfig(**EXP["model"]),
                             tokenizer=texp.base_exp.TokenizerConfig(**EXP["tokenizer"]),
                             data=texp.NaVILADataConfig(**EXP["data"]))
        exp.trainer = ttrainer.TrainerConfig(output_dir=str(tmp / "exp1"), **EXP_TRAINER)
        exp.optimizer = toptim.OptimizerConfig(**EXP_OPT)
        exp.train()
    finally:
        os.chdir(cwd)
    return {"tmp": tmp, "attn": attn, "got": got, "ref_attn": ref_attn, "ref_cp": ref_cp,
            "globs": globs, "params": params, "cfg": cfg}


def _cat(parts: list, key: str) -> np.ndarray:
    return torch.cat([p[key] for p in parts], 1).numpy()


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", sorted(ATTN))
def test_ring_matches_one_process(runs, world, name):
    """The ring at ``world`` processes: output and dq, dk, dv concatenated over
    the ranks equal the one-process flash attention at 1e-5; each rank ran
    ``world`` hops."""
    parts = [r[name] for r in runs["got"][world]["attn"]]
    assert [p["hops"] for p in parts] == [world] * world
    for key in ("out", "dq", "dk", "dv"):
        np.testing.assert_allclose(_cat(parts, key), runs["ref_attn"][name][key].numpy(),
                                   rtol=EXACT, atol=EXACT, err_msg=key)
    if name == "dead":  # a row that sees no key of any hop is 0
        seen = runs["attn"][name]["seen"]
        assert (~seen).any() and not _cat(parts, "out")[~seen].any()


@needs_jax
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", sorted(ATTN))
def test_ring_matches_jax(runs, world, name):
    """The same against JAX's ring_attention on a seq axis of ``world`` of the
    virtual devices: the output on the rows that see a key, every gradient."""
    c = runs["attn"][name]
    mesh = Mesh(np.asarray(jax.devices()[:world]), ("seq",))
    s3, s2 = P(None, "seq", None, None), P(None, "seq")
    seg = c["seg"] if c["seg"] is not None else np.zeros_like(c["grp"])

    def f(q, k, v, g, val, sg):
        return jring(q, k, v, g, g, val, axis_name="seq", q_seg=sg, kv_seg=sg)

    ring = jax.shard_map(f, mesh=mesh, in_specs=(s3, s3, s3, s2, s2, s2), out_specs=s3)

    def loss(q, k, v):
        return jnp.sum(ring(q, k, v, c["grp"], c["valid"], seg) * c["dout"])

    out = np.asarray(jax.jit(ring)(c["q"], c["k"], c["v"], c["grp"], c["valid"], seg))
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(c["q"], c["k"], c["v"])
    parts = [r[name] for r in runs["got"][world]["attn"]]
    seen = c["seen"]
    np.testing.assert_allclose(_cat(parts, "out")[seen], out[seen], rtol=TOL, atol=TOL)
    for key, g in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(_cat(parts, key), np.asarray(g), rtol=TOL, atol=TOL,
                                   err_msg=key)


@pytest.mark.parametrize("world", [2, 4])
def test_cp_loss_matches_one_process(runs, world):
    """navila_packed_loss_cp at seq=2 (2 processes) and data=2 x seq=2 (4,
    the decoder's matrices in FSDP2 groups): the loss and every gradient
    equal one process's navila_packed_loss on the global batch at 1e-5."""
    data = 1 if world == 2 else 2
    ref = runs["ref_cp"][data]
    outs = runs["got"][world]["cp"]
    assert (outs[0]["fsdp_layers"] > 0) == (data > 1)
    # a data rank's value is its rows' share times the ranks (models/losses.batch_mean),
    # the same on its seq ranks; the Trainer reports the mean over the data ranks
    seq = world // data
    for d in range(data):
        assert len({o["loss"] for o in outs[d * seq: (d + 1) * seq]}) == 1
    np.testing.assert_allclose(np.mean([o["loss"] for o in outs]), ref["loss"], rtol=EXACT)
    for o in outs:
        assert set(o["grads"]) == set(ref["grads"])
        for n, g in o["grads"].items():
            np.testing.assert_allclose(g.numpy(), ref["grads"][n].numpy(), rtol=EXACT,
                                       atol=EXACT, err_msg=n)


def test_cp_loss_keeps_its_mesh_when_another_is_made(runs):
    """A mesh made after the CP mesh (its 'seq' axis over all 4 processes)
    does not move the ring: navila_packed_loss_cp at data=2 x seq=2, with
    remat (the ring's layers recomputed in the backward), still equals one
    process's loss and every gradient at 1e-5."""
    ref = runs["ref_cp"][2]
    outs = runs["got"][4]["cp_later_mesh"]
    np.testing.assert_allclose(np.mean([o["loss"] for o in outs]), ref["loss"], rtol=EXACT)
    for o in outs:
        assert set(o["grads"]) == set(ref["grads"])
        for n, g in o["grads"].items():
            np.testing.assert_allclose(g.numpy(), ref["grads"][n].numpy(), rtol=EXACT,
                                       atol=EXACT, err_msg=n)


@needs_jax
@pytest.mark.parametrize("world", [2, 4])
def test_cp_loss_matches_jax(runs, world):
    """The same against JAX's navila_packed_loss_cp on a (data, 1, seq) mesh of
    the virtual devices, loss and every gradient, at 1e-3."""
    data = 1 if world == 2 else 2
    jcfg = jnav.NaVILAConfig(vlm=jvlm.VLMConfig(llm=jpresets.LLM_TEST, vit=jvit.ViTConfig(**VIT),
                                                projector_type="mlp_downsample"),
                             num_video_frames=2, use_soft_ce=True)
    mesh = Mesh(np.asarray(jax.devices()[:world]).reshape(data, 1, world // data),
                ("data", "model", "seq"))
    batch = {k: jnp.asarray(v) for k, v in runs["globs"][data].items()}
    fn = jax.jit(jax.value_and_grad(lambda p: jnav.navila_packed_loss_cp(
        p, jcfg, batch, mesh, soft_tokens=jnp.asarray(SOFT))[0]))
    jl, jg = fn(runs["params"])
    got = runs["got"][world]["cp"][0]
    loss = np.mean([o["loss"] for o in runs["got"][world]["cp"]])
    np.testing.assert_allclose(loss, float(jl), rtol=TOL)
    n = 0
    for name, val, _ in port_arrays(jax.device_get(jg)):
        np.testing.assert_allclose(got["grads"][name].numpy(), val, rtol=TOL, atol=TOL,
                                   err_msg=name)
        n += 1
    assert n == len(got["grads"])


def test_exp_train_context_parallel(runs):
    """One NaVILAExp.train() step at context_parallel_seq=2 (2 processes, a
    (1, 1, 2) mesh): loss, text_loss and grad_norm equal the one-process
    step's at 1e-5, and the primary wrote the checkpoint."""
    tmp = runs["tmp"]

    def log(path):
        with open(path / "metrics.jsonl") as f:
            return json.loads(f.read().splitlines()[-1])

    got, want = log(tmp / "out" / "exp"), log(tmp / "exp1")
    for key in ("loss", "text_loss", "grad_norm"):
        np.testing.assert_allclose(got[key], want[key], rtol=EXACT, err_msg=key)
    assert os.path.exists(tmp / "out" / "exp" / "checkpoint-1" / "params.pt")


def test_ring_group_of_one_and_refusals():
    """A ring of one hop (no process group) is the plain flash attention,
    bit for bit; ``impl="ring:..."`` needs a mesh with that axis, and
    ``multihost.shutdown`` leaves none."""
    from dexbotic_tpu_torch.ops.attention import attention
    from dexbotic_tpu_torch.parallel import mesh as pmesh
    from dexbotic_tpu_torch.parallel import multihost
    from dexbotic_tpu_torch.parallel.ring import ring_attention

    c = attn_inputs("packed")
    args = [torch.from_numpy(c[x]) for x in ("q", "k", "v", "grp", "grp", "valid")]
    seg = torch.from_numpy(c["seg"])
    one = ring_attention(*args, group=None, q_seg=seg, kv_seg=seg)
    assert torch.equal(one, flash_attention(*args, q_seg=seg, kv_seg=seg))
    prev, pmesh._CURRENT = pmesh._CURRENT, "a mesh whose groups are gone"
    try:
        assert not torch.distributed.is_initialized()
        multihost.shutdown()  # forgets the current mesh
        with pytest.raises(RuntimeError, match="no mesh"):
            attention(*args, impl="ring:seq", q_seg=seg, kv_seg=seg)
    finally:
        pmesh._CURRENT = prev
    with pytest.raises(ValueError, match="both"):
        ring_attention(*args, q_seg=seg)
