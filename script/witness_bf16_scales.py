"""An fp64 witness for the bf16 three-step Trainer comparison of
tests/test_torch_train.py (``bf16-scales``), at every order of drawing the
stacked norm scales.

    JAX_PLATFORMS=cpu python script/witness_bf16_scales.py [--out DIR]

For each of the 24 orders (``SCALE_DRAW_ORDERS``) the scales are drawn as the
test draws them, then three steps run three ways on the test's batches and
config (lr 1e-2, accumulation 2, weight decay 0.1, clip 1.0):

* the JAX Trainer and the port's Trainer in bf16 under JAX's dtype rule (the
  stacked norm scales train in bf16, each update rounded once);
* the witness: the port's model and Trainer from the same bf16-rounded
  weights, every float in fp64 (``Tensor.float`` returns fp64 inside, the
  clip norm and the AdamW moments are fp64), nothing rounded between steps:
  the three AdamW steps the two bf16 runs approximate.

Per order it prints, for the stacked norm scales, the largest distance in
bf16 spacings (at JAX's value) of port from JAX, port from the witness and
JAX from the witness, and each element where port and JAX part by more than
one spacing; then the largest of each over all orders.  It imports the test
module's helpers (tests/ on the path) and runs on the CPU, as the test does.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
from unittest import mock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_train as T  # noqa: E402
from dexbotic_tpu_torch.nn.core import cast_like_jax_  # noqa: E402

OCFG = dict(learning_rate=1e-2, freeze_llm=False, freeze_mm_vision=False, max_grad_norm=1.0,
            weight_decay=0.1)
TCFG = dict(max_steps=3, gradient_accumulation_steps=2, logging_steps=1, save_steps=100,
            resume=False)


@contextlib.contextmanager
def fp64():
    """The port's fp32 casts and its clip norm in fp64."""
    def norm(grads, mesh=None):
        return torch.stack([g.double().square().sum() for g in grads]).sum().sqrt()

    with mock.patch.object(torch.Tensor, "float", lambda self: self.to(torch.float64)), \
            mock.patch.object(T.toptim, "global_norm", norm):
        yield


def witness(params, batches, out: str) -> dict:
    """The stacked norm scales after three fp64 AdamW steps from the bf16 weights."""
    model = T._port_model(params)
    cast_like_jax_(model, torch.bfloat16)  # the bf16 runs' starting point
    model.double()
    b64 = [{k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in b.items()}
           for b in batches]
    with fp64():
        tt = T.ttrainer.Trainer(T._port_loss(False), model,
                                T.ttrainer.TrainerConfig(output_dir=out, bf16=False, **TCFG),
                                T.toptim.OptimizerConfig(**OCFG))
        tt.optimizer.mu = {n: m.double() for n, m in tt.optimizer.mu.items()}
        tt.optimizer.nu = {n: m.double() for n, m in tt.optimizer.nu.items()}
        tt.train(iter(b64))
        tt.close()
    return {n: p.detach().numpy() for n, p in model.named_parameters()}


def one_order(order, tmp: str) -> dict:
    params = T._jax_params()
    batches = [T._batch(10 + i) for i in range(3)]
    scales = T._stacked_norm_scales(T._port_model(params))
    T._draw_stacked_scales(params, scales, order)
    jt = T.jtrainer.Trainer(T._jax_loss(False), params,
                            T.jtrainer.TrainerConfig(output_dir=os.path.join(tmp, "jax"),
                                                     mesh_data=1, bf16=True, **TCFG),
                            T.joptim.OptimizerConfig(**OCFG))
    jt.train(iter(batches))
    model = T._port_model(params)
    tt = T.ttrainer.Trainer(T._port_loss(False), model,
                            T.ttrainer.TrainerConfig(output_dir=os.path.join(tmp, "port"),
                                                     bf16=True, **TCFG),
                            T.toptim.OptimizerConfig(**OCFG))
    tt.train(iter(batches))
    tt.close()
    wit = witness(params, batches, os.path.join(tmp, "witness"))
    got = dict(model.named_parameters())
    final = {n: v for n, v, _ in T.port_arrays(jax.device_get(jt.params))}
    row = {"order": list(order), "port_jax": 0.0, "port_witness": 0.0, "jax_witness": 0.0,
           "parted": []}
    for name in scales:
        j = final[name].astype(np.float64)
        p = got[name].detach().double().numpy()
        w = wit[name]
        sp = T._bf16_spacing(j)
        pj, pw, jw = np.abs(p - j) / sp, np.abs(p - w) / sp, np.abs(j - w) / sp
        row["port_jax"] = max(row["port_jax"], float(pj.max()))
        row["port_witness"] = max(row["port_witness"], float(pw.max()))
        row["jax_witness"] = max(row["jax_witness"], float(jw.max()))
        for i in map(tuple, np.argwhere(pj > 1)):
            row["parted"].append({"leaf": name, "index": [int(x) for x in i], "jax": float(j[i]),
                                  "port": float(p[i]), "witness": float(w[i]),
                                  "port_witness": float(pw[i]), "jax_witness": float(jw[i])})
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="a directory for the JSON result")
    args = ap.parse_args()
    rows = []
    for order in T.SCALE_DRAW_ORDERS:
        with tempfile.TemporaryDirectory() as tmp:
            rows.append(one_order(order, tmp))
        print(json.dumps(rows[-1]), flush=True)
    res = {"orders": len(rows), **{k: max(r[k] for r in rows)
                                   for k in ("port_jax", "port_witness", "jax_witness")},
           "parted": [dict(p, order=r["order"]) for r in rows for p in r["parted"]]}
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "witness_bf16_scales.json"), "w") as f:
            json.dump({"rows": rows, **res}, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
