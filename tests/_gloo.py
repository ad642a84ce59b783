"""Worker processes over gloo for the port's parallel tests.

:func:`spawn` runs a worker script (``python -c``, torch only, one thread
each) in N processes that join one process group through a ``file://``
rendezvous in the test's directory (the ``DEXBOTIC_*`` launch contract of
``parallel/multihost.py``).  The script finds the repo in ``PAR_REPO``, its
inputs in ``PAR_IN``, writes its outputs to ``PAR_OUT`` and names its cases
in ``PAR_CASES``; it must print ``WORKER DONE <rank>`` last.  A worker that
fails or outlives the time limit fails the test with its output, and every
worker is gone when :func:`spawn` returns.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT_S = 300

# the preamble of every worker script: the group, the helpers to read and write
PREAMBLE = '''
import json, os, sys
sys.path.insert(0, os.environ["PAR_REPO"])
import numpy as np
import torch
torch.set_num_threads(1)
from dexbotic_tpu_torch.parallel import mesh as pmesh
from dexbotic_tpu_torch.parallel import multihost

OUT, INP = os.environ["PAR_OUT"], os.environ["PAR_IN"]
assert multihost.maybe_initialize(device="cpu")
RANK, WORLD = multihost.process_index(), multihost.process_count()


def save(name, obj):
    torch.save(obj, os.path.join(OUT, f"{name}-{RANK}.pt"))


def load(name):
    return torch.load(os.path.join(INP, name + ".pt"), weights_only=False)
'''

EPILOGUE = '''
for name in os.environ["PAR_CASES"].split(","):
    globals()["case_" + name]()
    multihost.sync()
multihost.shutdown()
print(f"WORKER DONE {RANK}", flush=True)
'''


def spawn(tmp, world: int, script: str, cases: list, timeout: float = WORKER_TIMEOUT_S) -> list:
    """Run ``script``'s ``cases`` in ``world`` processes; returns their outputs."""
    (tmp / "out").mkdir(exist_ok=True)
    env = {k: v for k, v in os.environ.items() if k not in ("PYTEST_CURRENT_TEST", "PYTHONPATH")}
    env.update(PAR_REPO=REPO, PAR_OUT=str(tmp / "out"), PAR_IN=str(tmp / "in"),
               PAR_CASES=",".join(cases), DEXBOTIC_NUM_PROCESSES=str(world),
               DEXBOTIC_COORDINATOR=f"file://{tmp}/rendezvous-{world}-{cases[0]}",
               OMP_NUM_THREADS="1")
    code = PREAMBLE + script + EPILOGUE
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=str(tmp),
                              env=dict(env, DEXBOTIC_PROCESS_ID=str(i)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(world)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
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


def results(tmp, name: str, world: int) -> list:
    """Every rank's ``save(name, ...)``, in rank order."""
    import torch

    return [torch.load(tmp / "out" / f"{name}-{r}.pt", weights_only=False) for r in range(world)]
