"""Trainer: grad accumulation, clipping, checkpoints, resume, on one device
or over a mesh of processes.

Port of dexbotic_tpu/exp/trainer.py.  The dtype rules are the JAX trainer's:
``bf16`` casts every fp32 parameter with ndim >= 2 to bf16 with no fp32
master copy, gradients come back in the parameters' dtype (summed there over
micro-batches) and are cast to fp32 for the update, and the moments are fp32
(``exp/optim.py``).  A frozen vision tower (``freeze_mm_vision``) takes no
gradient at all; any other frozen parameter keeps ``requires_grad`` so that
its gradient counts in the clip norm, as in the JAX package, and is dropped
after it.

Each step draws its randomness from a ``torch.Generator`` seeded from
(seed, step, micro-batch) and the data rank, so step N draws the same
numbers whether or not training was resumed before it, and no two data
ranks draw the same stream.

The mesh path runs when a process group is initialised
(``parallel/multihost.maybe_initialize``) or when ``mesh_data`` /
``mesh_model`` ask for more than one process: the model is laid out by
``parallel/mesh.shard_model`` (tensor parallelism on 'model', FSDP2 on
'data'), each data rank takes its own rows of the global batch (the caller
feeds them: ``per_device_batch_size`` x accumulation rows a step), means
over tokens divide by the global batch's counts
(``models/losses.data_parallel``), the gradients are averaged over the data
ranks, the clip norm is the whole tree's and the moments are sharded like
their parameters.  A rank's micro-batch m is its own m-th slice of its
rows; the JAX package's is the m-th contiguous block of the global batch
(ROADMAP Queue 3).  Checkpoints are gathered and written by the primary
alone, in the one-process format, so either path resumes the other; logs
and metrics.jsonl are the primary's.  Without a group and a mesh the step
is the one-device path.  Checkpoints are ``checkpoint-{step}/``
directories holding ``trainer_state.json``, ``norm_stats.json`` and, in
torch's format, ``params.pt`` and ``opt_state.pt`` (or ``adapter.pt`` alone
under ``adapter_save``).  Every log line also goes to Weights & Biases when
``wandb_project`` (or WANDB_PROJECT) is set and ``wandb`` is installed, and
carries ``data_wait_s``, the seconds a step waited on its batch.

A stateful model (MemVLA's memory bank) passes ``aux_state``: its loss is
then ``loss_fn(model, batch, generator, aux) -> (loss, metrics, new_aux)``,
the new state is detached and carried to the next step, and the step takes
the whole batch at once whatever ``gradient_accumulation_steps`` says (the
state's order forbids splitting it), as the JAX trainer's aux step does.
Checkpoints hold no aux state: a resumed run starts from a fresh one.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from dexbotic_tpu_torch.exp.optim import Optimizer, OptimizerConfig, local, stopgrad_subtrees
from dexbotic_tpu_torch.models import losses
from dexbotic_tpu_torch.nn.core import cast_matrices_
from dexbotic_tpu_torch.parallel import multihost
from dexbotic_tpu_torch.parallel.mesh import make_mesh, mesh_requested, shard_model


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    output_dir: str = "./output"
    max_steps: int = 1000
    per_device_batch_size: int = 8
    gradient_accumulation_steps: int = 1
    logging_steps: int = 10
    save_steps: int = 500
    save_total_limit: Optional[int] = None
    seed: int = 42
    bf16: bool = True
    gradient_checkpointing: bool = False
    mesh_data: Optional[int] = None  # default: the processes left over by mesh_model
    mesh_model: int = 1
    resume: bool = True
    save_optimizer: bool = True  # persist moments for an exact resume
    # adapter-only checkpoints: just the projector (+ norm stats)
    adapter_save: bool = False
    wandb_project: Optional[str] = None  # uses the WANDB_PROJECT env var if unset


def step_generator(seed: int, step: int, micro: int, device, rank: int = 0) -> torch.Generator:
    """The generator of one micro-batch: a function of (seed, step, micro)
    and the data rank only (rank 0 draws what one process draws)."""
    entropy = [seed, step, micro] if rank == 0 else [seed, step, micro, rank]
    state = np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) & (2 ** 63 - 1))


def is_adapter(name: str) -> bool:
    """Whether parameter ``name`` belongs to the adapter (the projector)."""
    return "projector" in name.split(".")


def extract_adapter(model: nn.Module) -> dict:
    """{name: tensor on the host} of the projector's parameters (the adapter)."""
    return {n: p.detach().cpu() for n, p in model.named_parameters() if is_adapter(n)}


@torch.no_grad()
def apply_adapter(model: nn.Module, adapter: dict,
                  part: Callable[[str, torch.Tensor], torch.Tensor] = lambda name, v: v
                  ) -> nn.Module:
    """Copy an adapter into ``model``'s parameters of the same names; over
    a mesh, ``part(name, whole)`` is this rank's part of a parameter."""
    params = dict(model.named_parameters())
    missing = sorted(set(adapter) - set(params))
    if missing:
        raise KeyError(f"adapter keys not found in the model: {missing[:5]}")
    for name, value in adapter.items():
        p = local(params[name])
        p.copy_(part(name, value).to(p.dtype))
    return model


def load_checkpoint_params(path: str, base_params: Optional[dict] = None) -> dict:
    """{name: tensor} from a ``checkpoint-{step}`` directory.  An adapter-only
    checkpoint needs ``base_params`` to merge into."""
    adapter = os.path.join(path, "adapter.pt")
    if os.path.exists(adapter):
        if base_params is None:
            raise ValueError(f"{path} is an adapter-only checkpoint; pass base_params")
        merged = dict(base_params)
        merged.update(torch.load(adapter, map_location="cpu", weights_only=True))
        return merged
    return torch.load(os.path.join(path, "params.pt"), map_location="cpu", weights_only=True)


def detach_tree(tree):
    """A nested dict/list/tuple of tensors with every tensor detached."""
    if isinstance(tree, dict):
        return {k: detach_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(detach_tree(v) for v in tree)
    return tree.detach() if isinstance(tree, torch.Tensor) else tree


class Trainer:
    """Training loop around ``loss_fn(model, batch, generator) -> (loss,
    metrics)``, or ``loss_fn(model, batch, generator, aux) -> (loss, metrics,
    new_aux)`` with an ``aux_state`` carried between steps."""

    def __init__(self, loss_fn: Callable, model: nn.Module, trainer_config: TrainerConfig,
                 optimizer_config: OptimizerConfig, norm_stats_json: Optional[str] = None,
                 aux_state=None):
        self.cfg = trainer_config
        self.opt_cfg = optimizer_config
        self.loss_fn = loss_fn
        self.model = model
        self.norm_stats_json = norm_stats_json
        model.requires_grad_(True)
        if optimizer_config.freeze_mm_vision:
            stopgrad_subtrees(model.named_parameters(), ("vit", "mm_vision"))
        if trainer_config.bf16:
            cast_matrices_(model, torch.bfloat16)
        self.mesh = self.sharded = None
        self.data_rank, self.data_size = 0, 1
        if mesh_requested(trainer_config.mesh_data, trainer_config.mesh_model):
            device = next(model.parameters()).device
            self.mesh = make_mesh(trainer_config.mesh_data, trainer_config.mesh_model,
                                  device_type=device.type)
            self.sharded = shard_model(model, self.mesh)
            self.data_rank, self.data_size = self.sharded.data_rank, self.sharded.data_size
        self.params = dict(model.named_parameters())
        self.device = local(next(iter(self.params.values()))).device
        self.optimizer = Optimizer(optimizer_config, self.params.items(), trainer_config.max_steps,
                                   mesh=self.mesh)
        self.step = 0
        self.aux_state = aux_state
        self._metrics_file = None
        self._wandb = self._init_wandb()

    # ------------------------------------------------------------------

    def _loss(self, *args):
        """``loss_fn(model, *args)``; over a mesh, with the sharded groups
        gathered and the means over the global batch."""
        if self.sharded is None:
            return self.loss_fn(self.model, *args)
        with losses.data_parallel(self.sharded.data_group, self.data_size):
            return self.sharded(self.loss_fn, *args)

    def _generator(self, micro: int) -> torch.Generator:
        return step_generator(self.cfg.seed, self.step, micro, self.device, self.data_rank)

    def accumulate_grads(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """Forward and backward over the micro-batches of one batch (numpy
        arrays or tensors whose leading dim is accumulation x micro-batch:
        over a mesh, this data rank's rows).  Leaves each parameter's
        gradient, summed and averaged in its own dtype (and over the data
        ranks), in ``.grad``; returns (mean loss, the last micro-batch's
        metrics), this rank's.  With an aux state the batch is one
        micro-batch and the state moves on to the loss's new one."""
        batch = multihost.local_batch_to_global(batch, self.device)
        for p in self.params.values():
            p.grad = None
        if self.aux_state is not None:  # the whole batch in one step, the state carried
            loss, metrics, new_aux = self._loss(batch, self._generator(0), self.aux_state)
            loss.backward()
            self.aux_state = detach_tree(new_aux)
            if self.sharded is not None:
                self.sharded.reduce_replicated_grads()
            return loss.detach(), metrics
        accum = self.cfg.gradient_accumulation_steps
        loss_sum = 0.0
        for m in range(accum):
            if accum == 1:
                mb = batch
            else:
                mb = {k: v.reshape((accum, v.shape[0] // accum) + v.shape[1:])[m]
                      for k, v in batch.items()}
            loss, metrics = self._loss(mb, self._generator(m))
            loss.backward()
            loss_sum = loss_sum + loss.detach()
        if accum > 1:
            for p in self.params.values():
                if p.grad is not None:
                    local(p.grad).div_(accum)  # a shard in place: no DTensor dispatch
        if self.sharded is not None:
            self.sharded.reduce_replicated_grads()
        return loss_sum / accum, metrics

    def apply_gradients(self) -> torch.Tensor:
        """Clip and apply the gradients in ``.grad``, then drop them; returns
        the global norm of every gradient, frozen parameters' included."""
        grads = {n: p.grad for n, p in self.params.items() if p.requires_grad}
        grad_norm = self.optimizer.step_(self.params, grads)
        for p in self.params.values():
            p.grad = None
        return grad_norm

    def _data_mean(self, values: dict) -> dict:
        """Each 0-d metric averaged over the data ranks (one collective): the
        global batch's value, as the JAX package reports it."""
        if self.sharded is None or not values:
            return values
        stacked = torch.stack([v.detach().float().reshape(()) for v in values.values()])
        dist.all_reduce(stacked, group=self.sharded.data_group)
        return dict(zip(values, stacked / self.data_size))

    def train_step(self, batch: dict) -> dict:
        """One optimizer step on a global batch; returns float metrics."""
        loss, metrics = self.accumulate_grads(batch)
        metrics = self._data_mean(dict(metrics, _step_loss=loss))
        loss = metrics.pop("_step_loss")
        out = {k: float(v.detach()) for k, v in metrics.items()}
        out["grad_norm"] = float(self.apply_gradients())
        out["loss"] = float(loss)
        return out

    def train(self, data_iter: Iterable[dict], max_steps: Optional[int] = None) -> dict:
        """Run the loop over collated numpy batches; returns the last log."""
        max_steps = max_steps or self.cfg.max_steps
        if self.cfg.resume:
            self.maybe_resume()
        t0 = time.time()
        log = {}
        data_iter = iter(data_iter)
        wait, waited_steps = 0.0, 0
        while self.step < max_steps:
            t_wait = time.perf_counter()
            batch = next(data_iter, None)
            if batch is None:
                break
            wait += time.perf_counter() - t_wait
            waited_steps += 1
            metrics = self.train_step(batch)
            self.step += 1
            if self.step % self.cfg.logging_steps == 0 or self.step == max_steps:
                log = dict(metrics, step=self.step)
                log["steps_per_sec"] = self.cfg.logging_steps / max(1e-9, time.time() - t0)
                # seconds a step waited on its batch (host decode not hidden), since the last log
                log["data_wait_s"] = wait / waited_steps
                t0 = time.time()
                wait, waited_steps = 0.0, 0
                if multihost.is_primary():
                    print(json.dumps(log))
                    self._log_metrics(log)
            if self.step % self.cfg.save_steps == 0 or self.step == max_steps:
                self.save_checkpoint()
        return log

    # ------------------------------------------------------------------

    def _init_wandb(self):
        """A W&B run when ``wandb_project`` (or WANDB_PROJECT) is set and
        ``wandb`` imports and starts (offline, it may not), else None;
        metrics.jsonl is written either way."""
        project = self.cfg.wandb_project or os.environ.get("WANDB_PROJECT")
        if not project or not multihost.is_primary():
            return None
        try:
            import wandb

            return wandb.init(project=project, dir=self.cfg.output_dir)
        except Exception:  # noqa: BLE001 (not installed, or no network)
            return None

    def _log_metrics(self, log: dict) -> None:
        if self._metrics_file is None:
            os.makedirs(self.cfg.output_dir, exist_ok=True)
            self._metrics_file = open(os.path.join(self.cfg.output_dir, "metrics.jsonl"), "a")
        self._metrics_file.write(json.dumps(log) + "\n")
        self._metrics_file.flush()
        if self._wandb is not None:
            self._wandb.log(log, step=self.step)

    def close(self) -> None:
        if self._metrics_file is not None:
            self._metrics_file.close()
            self._metrics_file = None

    def _ckpt_dir(self, step: int) -> str:
        return os.path.join(self.cfg.output_dir, f"checkpoint-{step}")

    def _host(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """A whole host copy of ``t``, laid out as parameter ``name`` (a
        sharded parameter's moments are its local shards): gathered from
        every rank, so every rank calls this in the same order."""
        p = self.params[name]
        if hasattr(p, "device_mesh") and not hasattr(t, "device_mesh"):
            from torch.distributed.tensor import DTensor

            t = DTensor.from_local(t, p.device_mesh, p.placements, run_check=False,
                                   shape=p.shape, stride=p.stride())
        return multihost.host_copy(t.detach())

    def _part(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of a whole tensor laid out as parameter ``name``."""
        p = self.params[name]
        if not hasattr(p, "device_mesh"):
            return full
        from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

        shape, offset = compute_local_shape_and_global_offset(p.shape, p.device_mesh, p.placements)
        return full[tuple(slice(o, o + n) for o, n in zip(offset, shape))]

    def _gathered(self, tensors: dict) -> Optional[dict]:
        """{name: whole host copy} on the primary, None on the other ranks
        (which take part in the gathers and keep nothing)."""
        keep = multihost.is_primary()
        out = {}
        for name, t in tensors.items():
            host = self._host(name, t)
            if keep:
                out[name] = host
        return out if keep else None

    def save_checkpoint(self) -> str:
        """``checkpoint-{step}/`` in the one-process format, written by the
        primary alone; every rank returns after the writes."""
        path = os.path.abspath(self._ckpt_dir(self.step))
        primary = multihost.is_primary()
        if primary:
            os.makedirs(path, exist_ok=True)
        state = {"step": self.step}
        if self.cfg.adapter_save:
            names = {n: p for n, p in self.params.items() if is_adapter(n)}
            if not names:
                raise ValueError("adapter_save: the model has no projector parameters")
            adapter = self._gathered(names)
            if primary:
                torch.save(adapter, os.path.join(path, "adapter.pt"))
            state["adapter_only"] = True
        else:
            params = self._gathered(self.params)
            if primary:
                torch.save(params, os.path.join(path, "params.pt"))
                del params
            if self.cfg.save_optimizer:
                opt = self.optimizer.state_dict()
                mu, nu = self._gathered(opt["mu"]), self._gathered(opt["nu"])
                if primary:
                    torch.save({"count": opt["count"], "mu": mu, "nu": nu},
                               os.path.join(path, "opt_state.pt"))
        if primary:
            with open(os.path.join(path, "trainer_state.json"), "w") as f:
                json.dump(state, f)
            if self.norm_stats_json is not None:
                with open(os.path.join(path, "norm_stats.json"), "w") as f:
                    f.write(self.norm_stats_json)
            self._prune_checkpoints()
        multihost.sync("checkpoint")
        return path

    def _checkpoint_steps(self) -> list[int]:
        if not os.path.isdir(self.cfg.output_dir):
            return []
        return sorted(int(m.group(1)) for d in os.listdir(self.cfg.output_dir)
                      if (m := re.match(r"checkpoint-(\d+)$", d)))

    def _prune_checkpoints(self) -> None:
        if not self.cfg.save_total_limit:
            return
        for step in self._checkpoint_steps()[: -self.cfg.save_total_limit]:
            shutil.rmtree(self._ckpt_dir(step), ignore_errors=True)

    def latest_checkpoint(self) -> Optional[str]:
        steps = self._checkpoint_steps()
        return self._ckpt_dir(steps[-1]) if steps else None

    def maybe_resume(self) -> bool:
        """Load the newest checkpoint, whole, into every rank's part.  Every
        rank has read it before any returns: a checkpoint the primary starts
        writing next must not look like the newest to a slower rank."""
        resumed = self._resume()
        multihost.sync("resume")
        return resumed

    @torch.no_grad()
    def _resume(self) -> bool:
        path = self.latest_checkpoint()
        if path is None:
            return False
        with open(os.path.join(path, "trainer_state.json")) as f:
            self.step = json.load(f)["step"]
        adapter = os.path.join(path, "adapter.pt")
        if os.path.exists(adapter):
            apply_adapter(self.model, torch.load(adapter, map_location="cpu", weights_only=True),
                          self._part)
            if multihost.is_primary():
                print(f"resumed adapter-only checkpoint from {path} at step {self.step}")
            return True
        saved = torch.load(os.path.join(path, "params.pt"), map_location="cpu", weights_only=True,
                           mmap=True)
        for name, p in self.params.items():
            local(p).copy_(self._part(name, saved[name]).to(p.dtype))
        opt_path = os.path.join(path, "opt_state.pt")
        if os.path.exists(opt_path):
            if not self.optimizer.load_state_dict(
                    torch.load(opt_path, map_location="cpu", weights_only=True, mmap=True),
                    part=self._part):
                print("opt_state checkpoint does not match the trainable set; fresh moments")
        if multihost.is_primary():
            print(f"resumed from {path} at step {self.step}")
        return True
