"""The port's parallel layer (``dexbotic_tpu_torch/parallel/``) over gloo on the CPU.

Worker processes (``python -c``, torch only, one thread each, a ``file://``
rendezvous under the test's directory) run the mesh path at 2 and 4
processes; the parent computes the one-process references with the same
code (:data:`COMMON`) and the JAX references.  A global batch split over N
processes must train as the same batch in one process:

* a CogACT Trainer step (noise and timesteps injected, fp32) at data=2,
  model=2 (tensor parallelism) and data=2 x model=2: loss, grad_norm and
  every parameter and moment after two steps equal one process at 1e-5,
  and the data=2 run equals the JAX Trainer at the repo's 1e-3;
* the same step in bf16, whose sharded leaves form two FSDP2 groups (bf16
  matrices, fp32 vectors), at bf16's tolerances (below);
* a token-mean loss (CogACT's text loss) whose two ranks hold different
  numbers of labels, against one process and JAX;
* gradient accumulation 2 at 2 processes; MemVLA's aux step, each rank
  carrying its own rows of the bank; a GRPO update; ``train_rl()``, each
  process rolling out its own envs;
* checkpoints written at 2 processes resume at 1 and the reverse, exactly;
  metrics.jsonl is the primary's, once a step, also when the primary is the
  slow process; norm statistics computed by the primary alone;
* ``allgather_rollouts`` over uneven counts and prompt lengths, to the JAX
  test's expectations (tests/test_multihost.py).

The tiny models shard under ``FSDP_MIN_SIZE = 256`` so that FSDP2 holds the
decoder's matrices too.  Every worker run has a time limit: a hang fails
its test.
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from dexbotic_tpu_torch.parallel import mesh as tmesh
from dexbotic_tpu_torch.parallel import multihost
from dexbotic_tpu_torch.utils.bridge import load_jax_params

try:  # the JAX references; the card's machine has no JAX, and there they skip
    import jax
    import jax.numpy as jnp

    from dexbotic_tpu.exp import optim as joptim
    from dexbotic_tpu.exp import trainer as jtrainer
    from dexbotic_tpu.models import cogact as jcogact
    from dexbotic_tpu.models import vlm as jvlm
    from dexbotic_tpu.nn import transformer as jtransformer
    from dexbotic_tpu.nn import vit as jvit
    from dexbotic_tpu.parallel import mesh as jmesh
except ImportError:
    jax = None
needs_jax = pytest.mark.skipif(jax is None, reason="the JAX package is not installed")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-3  # against JAX
EXACT = 1e-5  # N processes against one, fp32
# bf16 (weights rounded at every update, gradients summed in bf16 in another
# order): losses and grad_norm to 1 %, weights to one bf16 step of their
# size plus two learning rates (an Adam update moves a weight by ~lr)
BF16_REL, BF16_LR = 1e-2, 1e-3
WORKER_TIMEOUT_S = 400

# torch-only helpers run by the workers and, for the one-process references,
# by this process (exec'd into a namespace)
COMMON = textwrap.dedent('''
    import json, os
    import numpy as np
    import torch
    from dexbotic_tpu_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX
    from dexbotic_tpu_torch.exp import optim as toptim
    from dexbotic_tpu_torch.exp import trainer as ttrainer
    from dexbotic_tpu_torch.models import cogact as tcogact
    from dexbotic_tpu_torch.models import memvla as tmem
    from dexbotic_tpu_torch.models import oft as toft
    from dexbotic_tpu_torch.models import presets as tpresets
    from dexbotic_tpu_torch.models import vlm as tvlm
    from dexbotic_tpu_torch.nn import transformer as ttransformer
    from dexbotic_tpu_torch.nn import vit as tvit

    LLM = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
               head_dim=8, intermediate_size=64, attn_impl="xla")
    VIT = dict(image_size=28, patch_size=14, hidden_size=24, num_layers=2, num_heads=4,
               intermediate_size=48, select_layer=None)
    CHUNK, REP = 4, 4
    TCFG = tcogact.CogActConfig(vlm=tvlm.VLMConfig(llm=ttransformer.TransformerConfig(**LLM),
                                                   vit=tvit.ViTConfig(**VIT)),
                                action_model_type="DiT-S", action_dim=7, chunk_size=CHUNK)
    MEM_CFG = tmem.MemVLAConfig(vlm=tvlm.VLMConfig(llm=tpresets.LLM_TEST,
                                                   vit=tpresets.VIT_TEST,
                                                   projector_type="mlp2x_gelu"),
                                action_model_type="DiT-S", action_dim=3, chunk_size=4,
                                per_token_size=16, mem_length=3, repeated_diffusion_steps=2)
    OFT_CFG = toft.OFTConfig(vlm=tvlm.VLMConfig(llm=tpresets.LLM_TEST, vit=tpresets.VIT_TEST),
                             action_model_type="Discrete", action_dim=3, chunk_size=4,
                             num_bins=32)


    def cogact_batch(seed, B=4, labels=None):
        """A collated CogACT batch with per-row diffusion draws [B, REP, ...];
        ``labels`` (a count a row) turns on the text loss's labels."""
        rng = np.random.default_rng(seed)
        nt = 4
        ids = rng.integers(1, 60, (B, nt + 6)).astype(np.int32)
        ids[:, :nt] = IMAGE_TOKEN_INDEX
        mask = np.ones(ids.shape, bool)
        out = {"input_ids": ids, "attention_mask": mask,
               "images": rng.standard_normal((B, 1, 28, 28, 3)).astype(np.float32),
               "actions": np.tanh(rng.standard_normal((B, CHUNK, 7))).astype(np.float32),
               "diff_t": rng.integers(0, 100, (B, REP)).astype(np.int32),
               "diff_noise": rng.standard_normal((B, REP, CHUNK, 7)).astype(np.float32)}
        if labels is not None:
            lab = np.full(ids.shape, IGNORE_INDEX, np.int32)
            for r, k in enumerate(labels):
                lab[r, nt: nt + k] = ids[r, nt: nt + k]
            out["labels"] = lab
        return out


    def rep_major(x):
        """[B, REP, ...] -> [REP * B, ...], the order of the loss's tiled rows."""
        return x.transpose(0, 1).reshape((-1,) + tuple(x.shape[2:]))


    def rows(batch, i, n):
        """Rank i's contiguous share of every array of a global batch."""
        return {k: v[len(v) * i // n: len(v) * (i + 1) // n] for k, v in batch.items()}


    def cogact_loss(text=False, remat=False):
        def loss_fn(model, batch, generator):
            return tcogact.cogact_loss(model, TCFG, batch, generator, with_text_loss=text,
                                       diffusion_t=rep_major(batch["diff_t"]),
                                       diffusion_noise=rep_major(batch["diff_noise"]),
                                       remat=remat)
        return loss_fn


    def train_cogact(out, weights, batches, data=None, model=1, bf16=False, accum=1,
                     text=False, steps=2, remat=False):
        """``steps`` Trainer steps of the CogACT in ``weights`` on ``batches``
        (global), each rank on its rows; checkpoint at the last step."""
        net = tcogact.build_cogact(TCFG, "cpu")
        net.load_state_dict(torch.load(weights))
        cfg = ttrainer.TrainerConfig(output_dir=out, max_steps=steps, logging_steps=1,
                                     save_steps=steps, bf16=bf16, resume=False, mesh_data=data,
                                     mesh_model=model, gradient_accumulation_steps=accum)
        tr = ttrainer.Trainer(cogact_loss(text, remat), net, cfg,
                              toptim.OptimizerConfig(learning_rate=1e-3))
        tr.train(rows(b, tr.data_rank, tr.data_size) for b in batches)
        tr.close()
        return tr


    def mem_batch(seed, B=4):
        rng = np.random.default_rng(seed)
        nt = MEM_CFG.vlm.num_image_tokens
        ids = rng.integers(1, 60, (B, nt + 6)).astype(np.int32)
        ids[:, :nt] = IMAGE_TOKEN_INDEX
        rep = MEM_CFG.repeated_diffusion_steps
        return {"input_ids": ids, "attention_mask": np.ones(ids.shape, np.int32),
                "images": rng.standard_normal((B, 1, 28, 28, 3)).astype(np.float32),
                "actions": np.tanh(rng.standard_normal((B, 4, 3))).astype(np.float32),
                "timesteps": (seed + np.arange(B)).astype(np.float32),
                "episode_reset": np.asarray([seed % 2 == 0, False, True, False][:B], bool),
                "diff_t": rng.integers(0, 100, (B, rep)).astype(np.int32),
                "diff_noise": rng.standard_normal((B, rep, 4, 3)).astype(np.float32)}


    def train_memvla(out, weights, batches, data=None, B=4):
        """Two aux steps (the bank a row) of the MemVLA in ``weights``; returns
        the trainer (its aux_state holds this rank's rows of the bank)."""
        def loss_fn(model, batch, generator, aux):
            return tmem.memvla_loss(model, MEM_CFG, batch, aux, generator,
                                    diffusion_t=rep_major(batch["diff_t"]),
                                    diffusion_noise=rep_major(batch["diff_noise"]))

        net = tmem.build_memvla(MEM_CFG, "cpu")
        net.load_state_dict(torch.load(weights))
        cfg = ttrainer.TrainerConfig(output_dir=out, max_steps=len(batches), logging_steps=1,
                                     save_steps=100, bf16=False, resume=False, mesh_data=data)
        tr = ttrainer.Trainer(loss_fn, net, cfg, toptim.OptimizerConfig(learning_rate=1e-3),
                              aux_state=None)
        tr.aux_state = tmem.init_mem_state(MEM_CFG, B // tr.data_size)
        tr.train(rows(b, tr.data_rank, tr.data_size) for b in batches)
        tr.close()
        return tr


    def grpo_update(weights, batch, mesh=None, micro=4):
        """One GRPO update of the OFT-Discrete actor in ``weights`` on the
        (global) ``batch``: (metrics, {name: whole parameter after it},
        {name: whole gradient of the first micro-batch})."""
        from dexbotic_tpu_torch.exp.rl import grpo as tgrpo
        from dexbotic_tpu_torch.exp.rl import rl_trainer as trl
        from dexbotic_tpu_torch.parallel import multihost

        net = toft.build_oft(OFT_CFG, "cpu")
        net.load_state_dict(torch.load(weights))
        up = trl.GRPOUpdater(OFT_CFG, tgrpo.GRPOConfig(entropy_coeff=0.01), net,
                             learning_rate=1e-3, mesh=mesh)
        first = {}
        apply = up.apply

        def recorded(model, grads):
            if not first:
                first.update({n: multihost.host_copy(g) for n, g in grads.items()
                              if g is not None})
            return apply(model, grads)

        up.apply = recorded
        _, metrics = up.update(net, {k: torch.from_numpy(v) for k, v in batch.items()}, micro)
        params = {n: multihost.host_copy(p.detach()) for n, p in net.named_parameters()}
        return metrics, params, first
''')

WORKER = textwrap.dedent('''
    import json, os, sys, time
    sys.path.insert(0, os.environ["PAR_REPO"])
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from dexbotic_tpu_torch.parallel import mesh as pmesh
    from dexbotic_tpu_torch.parallel import multihost

    OUT, INP = os.environ["PAR_OUT"], os.environ["PAR_IN"]
    assert multihost.maybe_initialize(device="cpu")
    pmesh.FSDP_MIN_SIZE = 256
    exec(open(os.path.join(INP, "common.py")).read())
    RANK, WORLD = multihost.process_index(), multihost.process_count()


    def dump(name, obj):
        with open(os.path.join(OUT, f"{name}-{RANK}.json"), "w") as f:
            json.dump(obj, f)


    def inputs(name):
        return dict(np.load(os.path.join(INP, name + ".npz")))


    def case_env():
        again = multihost.maybe_initialize(device="cpu")  # idempotent
        mesh = pmesh.make_mesh()
        errors = {}
        for what, fn in (("expert", lambda: pmesh.make_mesh(expert=2)),
                         ("cover", lambda: pmesh.make_mesh(data=WORLD, model=2))):
            try:
                fn()
                errors[what] = None
            except Exception as e:  # noqa: BLE001
                errors[what] = f"{type(e).__name__}: {e}"
        dump("env", {"again": again, "rank": RANK, "world": WORLD,
                     "primary": multihost.is_primary(),
                     "shape": pmesh.mesh_shape(mesh), "batch": pmesh.batch_sharding(mesh),
                     "errors": errors,
                     "gathered": multihost.allgather(np.asarray([[RANK, 7]], np.int64)).tolist(),
                     "stacked": multihost.allgather(np.asarray([RANK], np.int16),
                                                    tiled=False).tolist()})


    def case_cogact():
        w = os.path.join(INP, "cogact.pt")
        batches = [cogact_batch(100 + s) for s in range(2)]
        if WORLD == 4:
            train_cogact(os.path.join(OUT, "tp_dp"), w, batches, data=2, model=2)
            return
        from torch.distributed.tensor import DTensor

        shard, gathered = ttrainer.shard_model, []

        def probed(model, mesh):
            """shard_model, and a count of the decoder layers held whole
            each time a layer's call starts (after its own gather)."""
            out = shard(model, mesh)
            layers = [m for m in model.modules() if isinstance(m, ttransformer.DecoderLayer)]

            def count(*_):
                gathered.append(sum(not isinstance(m.attn.q.weight, DTensor) for m in layers))

            for m in layers:
                m.register_forward_pre_hook(count)
            return out

        ttrainer.shard_model = probed
        try:
            tr = train_cogact(os.path.join(OUT, "dp"), w, batches, data=2)
        finally:
            ttrainer.shard_model = shard
        dump("layer_groups", {
            "units": sorted(tr.sharded.layers), "most_gathered": max(gathered),
            "calls": len(gathered),
            "sharded_after": all(isinstance(p, DTensor) for n in tr.sharded.layers.values()
                                 for p in (tr.params[k] for k in n))})
        for remat in (True, "dots"):
            train_cogact(os.path.join(OUT, f"remat_{remat}"), w, batches, data=2, remat=remat)
        train_cogact(os.path.join(OUT, "tp"), w, batches, data=1, model=2)
        tr = train_cogact(os.path.join(OUT, "bf16"), w, batches, data=2, bf16=True)
        params = tr.params
        dump("bf16_groups", {
            "whole": sorted(str(d) for d in tr.sharded.groups),
            "layers": sorted({str(params[n].dtype) for names in tr.sharded.layers.values()
                              for n in names})})
        train_cogact(os.path.join(OUT, "accum"), w, [cogact_batch(200 + s, B=8) for s in range(2)],
                     data=2, accum=2)
        text = [cogact_batch(300 + s, labels=[6, 5, 1, 0]) for s in range(2)]
        train_cogact(os.path.join(OUT, "text"), w, text, data=2, text=True)


    def case_rl_refused():
        """train_rl() whose micro-batch cannot be split over every process
        (4 processes, micro_batch_size 2): refused before any collective."""
        from dexbotic_tpu_torch.exp import simplevla_rl_exp as ts

        exp = ts.SimpleVLARLExp(micro_batch_size=2, device="cpu")
        try:
            exp.train_rl()
            dump("rl_refused", None)
        except ValueError as e:
            dump("rl_refused", str(e))


    def case_memvla():
        tr = train_memvla(os.path.join(OUT, "mem"), os.path.join(INP, "memvla.pt"),
                          [mem_batch(10 + s) for s in range(2)], data=2)
        st = tr.aux_state
        np.savez(os.path.join(OUT, f"mem_state-{RANK}.npz"),
                 **{f"{r}.{k}": st[r][k].numpy() for r in st for k in st[r]})


    def case_resume():
        """The one-process checkpoint-2 (copied in by the test) resumed at two
        processes and written again as checkpoint-3, with no step between;
        rank 1 lists the checkpoints a second late, after the primary could
        have started writing checkpoint-3."""
        net = tcogact.build_cogact(TCFG, "cpu")
        cfg = ttrainer.TrainerConfig(output_dir=os.path.join(OUT, "resume2"), max_steps=2,
                                     bf16=False, resume=True, mesh_data=2)
        tr = ttrainer.Trainer(cogact_loss(), net, cfg, toptim.OptimizerConfig(learning_rate=1e-3))
        if RANK == 1:
            listing = tr.latest_checkpoint
            tr.latest_checkpoint = lambda: (time.sleep(1.0), listing())[1]
        tr.train(iter([]))
        assert tr.step == 2
        tr.step = 3
        tr.save_checkpoint()


    def case_skew():
        """The primary is the slow process and saves every step."""
        w = os.path.join(INP, "cogact.pt")
        net = tcogact.build_cogact(TCFG, "cpu")
        net.load_state_dict(torch.load(w))
        cfg = ttrainer.TrainerConfig(output_dir=os.path.join(OUT, "skew"), max_steps=3,
                                     logging_steps=1, save_steps=1, bf16=False, resume=False,
                                     save_optimizer=False)
        tr = ttrainer.Trainer(cogact_loss(), net, cfg, toptim.OptimizerConfig(learning_rate=1e-3))

        def batches():
            for s in range(3):
                if RANK == 0:
                    time.sleep(0.5)
                yield rows(cogact_batch(400 + s), tr.data_rank, tr.data_size)

        tr.train(batches())
        tr.close()


    def case_norm():
        """Norm statistics: the primary computes (slowly), the other polls."""
        from dexbotic_tpu_torch.exp import base_exp

        def compute(self, dataset_name):
            open(os.path.join(OUT, f"norm_computed-{RANK}"), "w").close()
            time.sleep(1.0)
            out = os.path.join(self.norm_save_path, "norm_stats.json")
            os.makedirs(self.norm_save_path, exist_ok=True)
            with open(out + ".tmp", "w") as f:
                json.dump({"norm_stats": {"default": {"min": [0.0], "max": [1.0]}}}, f)
            os.replace(out + ".tmp", out)
            return out

        base_exp.ComputeNormActionConfig.compute_norm_stats = compute
        os.chdir(os.path.join(OUT, "norm"))
        exp = base_exp.BaseExp(data=base_exp.DataConfig(dataset_name="some_suite"))
        base_exp.NORM_STATS_POLL_S = 0.05
        exp._auto_compute_norm_stats()
        dump("norm", {"path": os.path.abspath(exp.action.statistic_mapping)})


    def case_gather():
        from dexbotic_tpu_torch.exp.rl.rl_trainer import RolloutBuffer, allgather_rollouts

        n = 3 if RANK == 0 else 2  # uneven counts and prompt lengths
        buf = RolloutBuffer(n, max_chunks=2, obs_shapes={"images": (4, 4, 3)}, tokens_per_chunk=5)
        buf.input_ids = np.full((n, 6 + RANK), RANK * 100 + 7, np.int32)
        buf.prompt_valid = np.ones((n, 6 + RANK), np.int32)
        buf.bins[:] = RANK * 100 + np.arange(n)[:, None, None]
        buf.success[:] = RANK
        buf.truncated[:] = 0.0
        buf.group_index[:] = np.arange(n) + RANK * 10
        g = allgather_rollouts(buf, pad_prompt_to=8)
        dump("gather", {"n": g.n, "ids_shape": list(g.input_ids.shape),
                        "success": g.success.tolist(), "group_index": g.group_index.tolist(),
                        "bins30": int(g.bins[3, 0, 0]), "bins20": int(g.bins[2, 0, 0]),
                        "images_shape": list(g.obs["images"].shape),
                        "bins_sum": int(g.bins.sum()), "ids_sum": int(g.input_ids.sum()),
                        "ids": g.input_ids.tolist()})


    def case_grpo():
        mesh = pmesh.make_mesh(data=2)
        metrics, params, grads = grpo_update(os.path.join(INP, "oft.pt"), inputs("grpo_batch"), mesh)
        if multihost.is_primary():
            torch.save({"params": params, "grads": grads}, os.path.join(OUT, "grpo_params.pt"))
        dump("grpo", metrics)


    def case_rl():
        """SimpleVLARLExp.train_rl() at 2 processes: each rolls out its own 4
        mock envs, both hold the union of 8, the update runs on the mesh."""
        from dexbotic_tpu_torch.exp import base_exp as tb
        from dexbotic_tpu_torch.exp import oft_exp as to
        from dexbotic_tpu_torch.exp import simplevla_rl_exp as ts
        from dexbotic_tpu_torch.exp.rl import grpo as tg
        from dexbotic_tpu_torch.exp.rl import rl_trainer as trl

        exp = ts.SimpleVLARLExp(
            model=to.OFTModelConfig(llm_preset="test", vit_preset="test",
                                    action_model_type="Discrete", action_dim=3, chunk_size=4,
                                    num_bins=32),
            data=tb.DataConfig(image_processor="28"),
            env=ts.RLEnvConfig(env_type="mock", task_names=("t0", "t1"), num_envs=4,
                               max_episode_steps=12, obs_dim=(28, 28, 3)),
            rl_data=ts.RLDataLoaderConfig(n_samples=2, schedule="random", num_trials_per_task=3),
            rollout=trl.RolloutConfig(max_env_steps=12, chunk_steps=4, temperature=1.6),
            grpo=tg.GRPOConfig(entropy_coeff=0.001), rl_epochs=1, rl_steps_per_epoch=1,
            micro_batch_size=4, prompt_text_len=8, trainer=ttrainer.TrainerConfig(seed=0),
            device="cpu")
        model, hist = exp.train_rl()
        digest = sum(float(multihost.host_copy(p.detach()).double().sum())
                     for p in model.parameters())
        dump("rl", {"hist": [{k: v for k, v in h.items() if not k.startswith("timing/")}
                             for h in hist], "digest": digest})


    for name in os.environ["PAR_CASES"].split(","):
        globals()["case_" + name]()
        multihost.sync()
    multihost.shutdown()
    print(f"WORKER DONE {RANK}", flush=True)
''')


def _spawn(tmp, world, cases):
    """Run WORKER's ``cases`` in ``world`` processes; returns their outputs.
    A worker that fails or outlives WORKER_TIMEOUT_S fails the test, and
    every worker is gone when this returns."""
    env = {k: v for k, v in os.environ.items() if k not in ("PYTEST_CURRENT_TEST", "PYTHONPATH")}
    env.update(PAR_REPO=REPO, PAR_OUT=str(tmp / "out"), PAR_IN=str(tmp / "in"),
               PAR_CASES=",".join(cases), DEXBOTIC_NUM_PROCESSES=str(world),
               DEXBOTIC_COORDINATOR=f"file://{tmp}/rendezvous-{world}-{cases[0]}",
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", WORKER], cwd=str(tmp),
                              env=dict(env, DEXBOTIC_PROCESS_ID=str(i)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(world)]
    try:
        outs = [p.communicate(timeout=WORKER_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    failed = [i for i, (p, o) in enumerate(zip(procs, outs))
              if p.returncode != 0 or f"WORKER DONE {i}" not in o]
    assert not failed, "\n".join(f"process {i} (exit {procs[i].returncode}):\n{outs[i][-3000:]}"
                                  for i in failed)
    return outs


# ---------------------------------------------------------------------------
# inputs, references and the worker runs: once for the module
# ---------------------------------------------------------------------------

LLM = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
           head_dim=8, intermediate_size=64, attn_impl="xla")
VIT = dict(image_size=28, patch_size=14, hidden_size=24, num_layers=2, num_heads=4,
           intermediate_size=48, select_layer=None)


def _jax_cfg():
    return jcogact.CogActConfig(vlm=jvlm.VLMConfig(llm=jtransformer.TransformerConfig(**LLM),
                                                   vit=jvit.ViTConfig(**VIT)),
                                action_model_type="DiT-S", action_dim=7, chunk_size=4)


def _jax_cogact_params():
    params = jax.device_get(jcogact.init_cogact(jax.random.PRNGKey(0), _jax_cfg()))
    final = params["action_head"]["final"]
    rng = np.random.default_rng(0)
    for leaf in ("w", "b"):
        final[leaf] = rng.normal(0, 0.02, final[leaf].shape).astype(np.float32)
    return params


def _jax_loss(text):
    def loss_fn(params, batch, rng):
        t = jnp.swapaxes(batch["diff_t"], 0, 1).reshape(-1)
        n = jnp.swapaxes(batch["diff_noise"], 0, 1).reshape((-1, 4, 7))
        return jcogact.cogact_loss(params, _jax_cfg(), batch, rng, with_text_loss=text,
                                   diffusion_t=t, diffusion_noise=n)
    return loss_fn


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Inputs, the one-process references (this process) and the worker runs."""
    tmp = tmp_path_factory.mktemp("parallel")
    (tmp / "in").mkdir()
    (tmp / "out" / "norm").mkdir(parents=True)
    with open(tmp / "in" / "common.py", "w") as f:
        f.write(COMMON)
    ns: dict = {}
    exec(COMMON, ns)
    net = ns["tcogact"].build_cogact(ns["TCFG"], "cpu")
    params = None
    if jax is not None:  # the JAX init, bridged, so that the JAX Trainer starts from it too
        params = _jax_cogact_params()
        load_jax_params(net, params)
    else:  # the port's own init; the DiT's zero final layer redrawn
        with torch.no_grad():
            net.action_head.final.weight.normal_(0.0, 0.02, generator=torch.Generator()
                                                 .manual_seed(0))
    torch.save(net.state_dict(), tmp / "in" / "cogact.pt")
    mem = ns["tmem"].build_memvla(ns["MEM_CFG"], "cpu", seed=0)
    with torch.no_grad():  # the zero-initialised outputs redrawn, so that the loss sees them
        g = torch.Generator().manual_seed(5)
        for name, p in mem.named_parameters():
            if p.ndim >= 1 and not p.any():
                p.normal_(0.0, 0.05, generator=g)
    torch.save(mem.state_dict(), tmp / "in" / "memvla.pt")
    torch.save(ns["toft"].build_oft(ns["OFT_CFG"], "cpu", seed=1).state_dict(),
               tmp / "in" / "oft.pt")
    rng = np.random.default_rng(0)
    n, T = 8, ns["OFT_CFG"].num_action_tokens
    nt = ns["OFT_CFG"].vlm.num_image_tokens
    ids = rng.integers(1, 400, (n, nt + 4)).astype(np.int64)
    ids[:, :nt] = ns["IMAGE_TOKEN_INDEX"]
    mask = np.ones((n, T), np.float32)
    mask[1, 3:] = mask[4, :] = mask[6, 5:] = 0.0  # a different number of tokens a row
    grpo_batch = {"input_ids": ids, "prompt_valid": np.ones_like(ids, dtype=bool),
                  "images": rng.normal(size=(n, 28, 28, 3)).astype(np.float32),
                  "bins": rng.integers(0, ns["toft"].decode_slots(ns["OFT_CFG"]),
                                       (n, T)).astype(np.int32),
                  "old_logp": rng.normal(-3.5, 0.3, (n, T)).astype(np.float32),
                  "advantages": (rng.normal(size=(n, 1)) * mask).astype(np.float32),
                  "token_mask": mask}
    np.savez(tmp / "in" / "grpo_batch.npz", **grpo_batch)

    ref = tmp / "ref"
    w = str(tmp / "in" / "cogact.pt")
    batches = [ns["cogact_batch"](100 + s) for s in range(2)]
    ns["train_cogact"](str(ref / "plain"), w, batches)
    ns["train_cogact"](str(ref / "bf16"), w, batches, bf16=True)
    ns["train_cogact"](str(ref / "accum"), w, [ns["cogact_batch"](200 + s, B=8) for s in range(2)],
                       accum=2)
    text = [ns["cogact_batch"](300 + s, labels=[6, 5, 1, 0]) for s in range(2)]
    ns["train_cogact"](str(ref / "text"), w, text, text=True)
    mem_tr = ns["train_memvla"](str(ref / "mem"), str(tmp / "in" / "memvla.pt"),
                                [ns["mem_batch"](10 + s) for s in range(2)])
    grpo = ns["grpo_update"](str(tmp / "in" / "oft.pt"), grpo_batch)
    shutil.copytree(ref / "plain", tmp / "out" / "resume2")
    outs = _spawn(tmp, 2, ["env", "cogact", "memvla", "resume", "skew", "norm", "gather", "grpo",
                           "rl"])
    outs4 = _spawn(tmp, 4, ["cogact", "rl_refused"])
    yield {"tmp": tmp, "out": tmp / "out", "ref": ref, "params": params, "batches": batches,
           "text": text, "mem": mem_tr, "grpo": grpo, "outs": outs, "outs4": outs4}
    shutil.rmtree(tmp, ignore_errors=True)  # ~2 GB of checkpoints


def _read(run):
    with open(run / "metrics.jsonl") as f:
        logs = [json.loads(line) for line in f]
    ckpt = run / f"checkpoint-{logs[-1]['step']}"
    return (logs, torch.load(ckpt / "params.pt"), torch.load(ckpt / "opt_state.pt"))


def _assert_runs_equal(got, want, rtol, atol, keys=("loss", "grad_norm", "action_loss")):
    (glog, gp, go), (wlog, wp, wo) = got, want
    assert [r["step"] for r in glog] == [r["step"] for r in wlog]
    for g, w in zip(glog, wlog):
        for k in keys:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol, err_msg=k)
    assert gp.keys() == wp.keys()
    for name in wp:
        assert gp[name].dtype == wp[name].dtype and gp[name].shape == wp[name].shape, name
        np.testing.assert_allclose(gp[name].float().numpy(), wp[name].float().numpy(), rtol=rtol,
                                   atol=atol, err_msg=name)
    assert go["count"] == wo["count"] and go["mu"].keys() == wo["mu"].keys()
    for key in ("mu", "nu"):
        for name in wo[key]:
            np.testing.assert_allclose(go[key][name].numpy(), wo[key][name].numpy(),
                                       rtol=rtol, atol=atol, err_msg=f"{key} {name}")


# ---------------------------------------------------------------------------
# the launch contract and the rules, in this process
# ---------------------------------------------------------------------------

def test_maybe_initialize_leaves_a_plain_run_alone(monkeypatch):
    for var in ("DEXBOTIC_COORDINATOR", "DEXBOTIC_NUM_PROCESSES", "DEXBOTIC_PROCESS_ID",
                "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.maybe_initialize(device="cpu") is False
    assert not torch.distributed.is_initialized()
    assert (multihost.process_index(), multihost.process_count(), multihost.is_primary()) == \
        (0, 1, True)
    multihost.sync()  # a no-op in one process
    np.testing.assert_array_equal(multihost.allgather(np.arange(3)), np.arange(3))
    assert multihost.allgather(np.arange(3), tiled=False).shape == (1, 3)
    # torchrun's variables are read as the DEXBOTIC_* ones they mirror
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29500")
    assert multihost._coordinator_from_env() == "10.0.0.1:29500"
    monkeypatch.setenv("DEXBOTIC_COORDINATOR", "file:///x")
    assert multihost._coordinator_from_env() == "file:///x"
    monkeypatch.setenv("WORLD_SIZE", "2")  # no rank: refused, nothing initialised
    with pytest.raises(ValueError, match="process's id"):
        multihost.maybe_initialize(device="cpu")
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh()


def test_worker_launch_contract_and_mesh(runs):
    for rank in range(2):
        with open(runs["out"] / f"env-{rank}.json") as f:
            env = json.load(f)
        assert env["again"] is True and env["rank"] == rank and env["world"] == 2
        assert env["primary"] == (rank == 0)
        assert env["shape"] == {"data": 2, "model": 1} and env["batch"] == [rank, 2]
        assert "11c" in env["errors"]["expert"] and "needs 4 processes" in env["errors"]["cover"]
        assert env["gathered"] == [[0, 7], [1, 7]] and env["stacked"] == [[0], [1]]


@needs_jax
@pytest.mark.parametrize("data", [2, 4, 8])
def test_fsdp_param_specs_match_jax(data):
    """The FSDP placement rule, a pure function of shapes, against the JAX
    rule on a JAX mesh of ``data`` devices (the JAX test's cases and more)."""
    shapes = {"big": (16, 1024, 32), "small": (4,), "scalar": (), "odd": (129, 127),
              "tie": (64, 64), "col": (3, 6144), "min": (128, 128), "under": (127, 128)}
    mesh = jmesh.make_mesh(data=data, model=1, devices=jax.devices()[:data])
    for min_size in (128, 2 ** 14):
        want = jmesh.fsdp_param_specs({k: jnp.zeros(s) for k, s in shapes.items()}, mesh,
                                      min_size=min_size)
        got = tmesh.fsdp_param_specs(shapes, data, min_size)
        for k, spec in want.items():
            axis = next((a for a, s in enumerate(spec) if s == "data"), None)
            assert got[k] == axis, (k, data, min_size)
    assert tmesh.fsdp_param_specs(shapes, 1, 128) == {k: None for k in shapes}
    assert tmesh.fsdp_param_specs({"big": (16, 1024, 32)}, 8, 128) == {"big": 1}


def test_tp_plan_covers_the_decoders_and_refuses_bad_heads():
    ns: dict = {}
    exec(COMMON, ns)
    net = ns["tcogact"].build_cogact(ns["TCFG"], "cpu")
    plan = tmesh.tp_plan(net, 2)
    layer = [f"vlm.llm.layers.{i}.{m}" for i in range(2)
             for m in ("attn.q", "attn.k", "attn.v", "attn.o", "mlp.gate", "mlp.up", "mlp.down")]
    assert sorted(plan) == sorted(layer + ["vlm.llm.embed"])
    kinds = {type(s).__name__ for s in plan.values()}
    assert kinds == {"ColwiseParallel", "RowwiseParallel"}
    assert not any(k.startswith(("vlm.vit", "action_head")) for k in plan)
    with pytest.raises(ValueError, match="divisible"):  # 2 kv heads over 4 ranks
        tmesh.tp_plan(net, 4)


# ---------------------------------------------------------------------------
# N processes against one, and against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("run,ref,keys", [
    ("dp", "plain", ("loss", "grad_norm", "action_loss")),
    ("tp", "plain", ("loss", "grad_norm", "action_loss")),
    ("tp_dp", "plain", ("loss", "grad_norm", "action_loss")),
    ("remat_True", "plain", ("loss", "grad_norm", "action_loss")),
    ("remat_dots", "plain", ("loss", "grad_norm", "action_loss")),
    ("accum", "accum", ("loss", "grad_norm"))])
def test_cogact_steps_over_processes_match_one_process(runs, run, ref, keys):
    """data=2, model=2 (tensor parallel), data=2 x model=2 at 4 processes,
    data=2 with each decoder layer recomputed in the backward (remat True and
    "dots", whose recomputation runs inside the layer's gather), and
    accumulation 2 at data=2 (8 rows: a rank's micro-batch is its own half,
    the union of the ranks' halves the global micro-batch, so the last
    micro-batch's action_loss is another set of rows'): loss, grad_norm,
    every parameter and moment after two steps, at 1e-5."""
    _assert_runs_equal(_read(runs["out"] / run), _read(runs["ref"] / ref), EXACT, EXACT, keys)


@needs_jax
def test_cogact_steps_over_processes_match_jax(runs, tmp_path):
    jt = jtrainer.Trainer(_jax_loss(False), runs["params"],
                          jtrainer.TrainerConfig(output_dir=str(tmp_path), max_steps=2,
                                                 logging_steps=1, save_steps=100, bf16=False,
                                                 resume=False, mesh_data=1),
                          joptim.OptimizerConfig(learning_rate=1e-3))
    jt.train(iter(runs["batches"]))
    with open(tmp_path / "metrics.jsonl") as f:
        jlog = [json.loads(line) for line in f]
    logs, params, _ = _read(runs["out"] / "dp")
    for g, w in zip(logs, jlog):
        for k in ("loss", "grad_norm", "action_loss"):
            np.testing.assert_allclose(g[k], w[k], rtol=TOL, atol=TOL, err_msg=k)
    from dexbotic_tpu_torch.utils.bridge import port_arrays

    for name, val, _ in port_arrays(jax.device_get(jt.params)):
        np.testing.assert_allclose(params[name].numpy(), val, rtol=TOL, atol=TOL, err_msg=name)


def test_bf16_step_shards_each_dtype_in_its_own_group(runs):
    """The trainer's dtype rule (bf16 matrices, fp32 vectors) gives FSDP2 one
    group a dtype; two steps at data=2 equal one process at bf16's
    tolerance, and every parameter keeps its dtype."""
    for rank in range(2):
        with open(runs["out"] / f"bf16_groups-{rank}.json") as f:
            assert json.load(f) == {"whole": ["torch.bfloat16", "torch.float32"],
                                    "layers": ["torch.bfloat16"]}
    (glog, gp, go), (wlog, wp, wo) = _read(runs["out"] / "bf16"), _read(runs["ref"] / "bf16")
    for g, w in zip(glog, wlog):
        for k in ("loss", "grad_norm", "action_loss"):
            np.testing.assert_allclose(g[k], w[k], rtol=BF16_REL, err_msg=k)
    assert {str(v.dtype) for v in gp.values()} == {"torch.bfloat16", "torch.float32"}
    for name in wp:
        assert gp[name].dtype == wp[name].dtype, name
        w = wp[name].float()
        step = 2.0 ** -7 * w.abs() + 2 * 2 * BF16_LR  # two steps
        assert ((gp[name].float() - w).abs() <= step).all(), name
    assert go["count"] == wo["count"] == 2


def test_decoder_layers_are_gathered_one_at_a_time(runs):
    """Each decoder layer is an FSDP2 group of its own: when a layer's call
    starts, it alone is whole (FSDP2 prefetches no layer in the forward),
    and after the step every layer's leaves are shards again."""
    for rank in range(2):
        with open(runs["out"] / f"layer_groups-{rank}.json") as f:
            got = json.load(f)
        assert got["units"] == ["vlm.llm.layers.0", "vlm.llm.layers.1"]
        assert got["calls"] >= 2 * 2 and got["most_gathered"] == 1
        assert got["sharded_after"] is True


@pytest.mark.parametrize("processes,model,micro,data", [
    (1, 1, 8, 1), (2, 1, 4, 2), (4, 1, 8, 4), (8, 1, 8, 8), (4, 2, 8, 2),
    (16, 1, 8, None), (6, 1, 8, None), (4, 1, 2, None), (6, 2, 8, None), (3, 2, 8, None)])
def test_grpo_update_mesh_covers_every_process(processes, model, micro, data):
    """The GRPO update's data size is the JAX recipe's gcd(processes //
    model, micro_batch_size); where that mesh would leave processes out of
    the update (JAX updates on the first data x model devices), it is
    refused with the way out in the message."""
    from dexbotic_tpu_torch.exp.simplevla_rl_exp import update_mesh_data

    if data is not None:
        assert update_mesh_data(processes, model, micro) == data
    else:
        with pytest.raises(ValueError, match="must cover all"):
            update_mesh_data(processes, model, micro)


def test_train_rl_refuses_a_mesh_short_of_the_processes(runs):
    """train_rl() at 4 processes with micro_batch_size 2 fails on every
    rank, before any collective, naming the fix."""
    for rank in range(4):
        with open(runs["out"] / f"rl_refused-{rank}.json") as f:
            msg = json.load(f)
        assert msg is not None and "must cover all 4 processes" in msg
        assert "set mesh_data" in msg


def test_token_mean_loss_with_uneven_labels(runs):
    """CogACT's text loss, rank 0's rows holding 11 labels and rank 1's 1:
    the mean is over the global batch's 12, in value and gradient, equal to
    one process at 1e-5 (a mean of the ranks' own means would weigh rank 1's
    single label as 11 of rank 0's)."""
    got, want = _read(runs["out"] / "text"), _read(runs["ref"] / "text")
    _assert_runs_equal(got, want, EXACT, EXACT, keys=("loss", "grad_norm", "text_loss"))
    assert got[0][0]["text_loss"] > 0


@needs_jax
def test_token_mean_loss_with_uneven_labels_matches_jax(runs, tmp_path):
    """The same two steps against the JAX Trainer on the global batch (1e-3)."""
    jt = jtrainer.Trainer(_jax_loss(True), runs["params"],
                          jtrainer.TrainerConfig(output_dir=str(tmp_path), max_steps=2,
                                                 logging_steps=1, save_steps=100, bf16=False,
                                                 resume=False, mesh_data=1),
                          joptim.OptimizerConfig(learning_rate=1e-3))
    jt.train(iter(runs["text"]))
    with open(tmp_path / "metrics.jsonl") as f:
        jlog = [json.loads(line) for line in f]
    logs, params, _ = _read(runs["out"] / "text")
    for g, w in zip(logs, jlog):
        for k in ("loss", "grad_norm", "text_loss"):
            np.testing.assert_allclose(g[k], w[k], rtol=TOL, atol=TOL, err_msg=k)
    from dexbotic_tpu_torch.utils.bridge import port_arrays

    for name, val, _ in port_arrays(jax.device_get(jt.params)):
        np.testing.assert_allclose(params[name].numpy(), val, rtol=TOL, atol=TOL, err_msg=name)


def test_memvla_aux_step_carries_each_ranks_rows(runs):
    """MemVLA's bank as the aux state at data=2: each rank carries the bank
    of its own 2 rows; loss, grad_norm and every parameter after two steps
    equal one process on the 4 rows, and the ranks' banks are its rows."""
    _assert_runs_equal(_read(runs["out"] / "mem"), _read(runs["ref"] / "mem"), EXACT, EXACT)
    ref = runs["mem"].aux_state
    for rank in range(2):
        st = np.load(runs["out"] / f"mem_state-{rank}.npz")
        for role in ref:
            for key in ref[role]:
                want = ref[role][key][2 * rank: 2 * rank + 2].numpy()
                np.testing.assert_allclose(st[f"{role}.{key}"], want, rtol=EXACT, atol=EXACT)


def test_checkpoints_resume_across_process_counts(runs, tmp_path):
    """A one-process checkpoint resumed at two processes and written again
    holds exactly its parameters and moments; a two-process checkpoint
    (written by the primary alone, in the one-process format) resumes at one
    process exactly; metrics.jsonl holds a line a step, the primary's."""
    ns: dict = {}
    exec(COMMON, ns)
    ref = runs["ref"] / "plain" / "checkpoint-2"
    again = runs["out"] / "resume2" / "checkpoint-3"
    for f in ("params.pt", "opt_state.pt"):
        a, b = torch.load(ref / f), torch.load(again / f)
        if f == "opt_state.pt":
            assert a["count"] == b["count"]
            a, b = {**a["mu"], **{"nu." + k: v for k, v in a["nu"].items()}}, \
                {**b["mu"], **{"nu." + k: v for k, v in b["nu"].items()}}
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    shutil.copytree(runs["out"] / "dp", tmp_path / "dp")
    net = ns["tcogact"].build_cogact(ns["TCFG"], "cpu")
    tr = ns["ttrainer"].Trainer(ns["cogact_loss"](), net, ns["ttrainer"].TrainerConfig(
        output_dir=str(tmp_path / "dp"), max_steps=2, bf16=False),
        ns["toptim"].OptimizerConfig(learning_rate=1e-3))
    assert tr.maybe_resume() and tr.step == 2
    saved = torch.load(runs["out"] / "dp" / "checkpoint-2" / "params.pt")
    for name, p in net.named_parameters():
        assert torch.equal(p.detach(), saved[name]), name
    opt = torch.load(runs["out"] / "dp" / "checkpoint-2" / "opt_state.pt")
    assert tr.optimizer.count == opt["count"] == 2
    for name, m in tr.optimizer.mu.items():
        assert torch.equal(m, opt["mu"][name]) and torch.equal(tr.optimizer.nu[name],
                                                               opt["nu"][name])
    with open(runs["out"] / "dp" / "metrics.jsonl") as f:
        assert [json.loads(line)["step"] for line in f] == [1, 2]
    assert sum('"step": 1' in o for o in runs["outs"]) == 1  # printed by the primary only
    assert '"step": 1' in runs["outs"][0]


def test_skewed_primary_writes_once_a_step(runs):
    """The primary sleeps 0.5 s a batch and saves every step (parameters
    only): both finish, every checkpoint is whole, metrics.jsonl has one
    line a step."""
    for step in (1, 2, 3):
        ckpt = runs["out"] / "skew" / f"checkpoint-{step}"
        assert sorted(os.listdir(ckpt)) == ["params.pt", "trainer_state.json"]  # no moments
        assert json.loads((ckpt / "trainer_state.json").read_text()) == {"step": step}
    lines = (runs["out"] / "skew" / "metrics.jsonl").read_text().strip().splitlines()
    assert [json.loads(line)["step"] for line in lines] == [1, 2, 3]


def test_norm_stats_primary_computes_the_other_polls(runs):
    paths = []
    for rank in range(2):
        with open(runs["out"] / f"norm-{rank}.json") as f:
            paths.append(json.load(f)["path"])
    assert paths[0] == paths[1] and os.path.exists(paths[0])
    assert os.path.exists(runs["out"] / "norm_computed-0")
    assert not os.path.exists(runs["out"] / "norm_computed-1")


def test_allgather_rollouts_uneven_counts_and_prompts(runs):
    """tests/test_multihost.py's expectations, on both processes alike."""
    got = []
    for rank in range(2):
        with open(runs["out"] / f"gather-{rank}.json") as f:
            got.append(json.load(f))
    g = got[0]
    assert g["n"] == 5 and g["ids_shape"] == [5, 8]
    assert g["success"] == [0.0, 0.0, 0.0, 1.0, 1.0]
    assert g["group_index"] == [0, 1, 2, 10, 11]
    assert g["bins30"] == 100 and g["bins20"] == 2
    assert g["images_shape"] == [5, 2, 4, 4, 3]
    assert g["ids"][0] == [7] * 6 + [0, 0] and g["ids"][3] == [107] * 7 + [0]
    assert got[0] == got[1]  # the identical union on every process


def test_grpo_update_over_processes_matches_one_process(runs):
    """One GRPO update (8 rows, micro-batches of 4, rows holding different
    numbers of tokens) at data=2 against one process: the metrics (masked
    means over each whole micro-batch) and the first micro-batch's gradient
    at 1e-5, every parameter after the update at 1e-5.  Adam divides a
    gradient by its own magnitude plus eps (1e-8): an element whose gradient
    cancels to that order (float order differs between the two runs) takes a
    step of another size, so those elements are held to the step's bound,
    2 lr an update, instead."""
    want_metrics, want, want_grads = runs["grpo"]
    saved = torch.load(runs["out"] / "grpo_params.pt")
    got, grads = saved["params"], saved["grads"]
    for rank in range(2):
        with open(runs["out"] / f"grpo-{rank}.json") as f:
            metrics = json.load(f)
        assert metrics.keys() == want_metrics.keys()
        for k in want_metrics:
            np.testing.assert_allclose(metrics[k], want_metrics[k], rtol=EXACT, atol=EXACT,
                                       err_msg=k)
    assert grads.keys() == want_grads.keys() and got.keys() == want.keys()
    lr, updates = 1e-3, 2
    scale = max(float(g.abs().max()) for g in want_grads.values())
    for name in want:
        g, w = want_grads[name], want[name]
        np.testing.assert_allclose(grads[name].numpy(), g.numpy(), rtol=EXACT,
                                   atol=EXACT * scale, err_msg=name)
        cond = g.abs() > 1e-6  # Adam's eps is far below these gradients
        diff = (got[name] - w).abs()
        assert (diff[cond] <= EXACT + EXACT * w[cond].abs()).all(), name
        assert (diff <= 2 * lr * updates).all(), name


def test_simplevla_train_rl_over_processes(runs):
    """train_rl() at 2 processes: every process holds the union of both
    processes' 8 rollouts (4 mock envs each), the update runs on a data=2
    mesh, and both end with the same metrics and the same weights."""
    got = []
    for rank in range(2):
        with open(runs["out"] / f"rl-{rank}.json") as f:
            got.append(json.load(f))
    assert got[0] == got[1]
    (h,) = got[0]["hist"]
    assert h["num_rollouts"] == 8 and h["step"] == 0
    assert all(np.isfinite(v) for v in h.values())
