"""Where a script's wall time goes: run it while a thread samples the main
thread's Python stack every ``--interval`` seconds, then write the seconds
seen (samples x interval) as JSON, by

- ``phase``: the outermost frame of the script whose function is named
  ``phase_*`` (else its innermost frame's function);
- ``chain``: the script's own frames, outermost first, with the line of the
  innermost;
- ``leaf``: the innermost frame anywhere (file:function:line);
- ``repo``: the innermost frame in ``dexbotic_tpu_torch/`` or ``script/``.

The file is rewritten every 30 s and at the end, so a run cut short leaves
what it saw.  The script runs as ``__main__`` with its own directory first
on ``sys.path``, as ``python3 SCRIPT`` would run it, and its exit code is
passed on:

    python3 script/sample_stacks_torch.py chiprun_out/stacks.json chip_smoke.py
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import runpy
import sys
import threading
import time


def _sampler(out: str, script: str, interval: float):
    main = threading.main_thread().ident
    names = {script, os.path.abspath(script)}  # the script may change its working directory
    seen = {k: collections.Counter() for k in ("phase", "chain", "leaf", "repo")}

    def dump():
        with open(out, "w") as f:
            json.dump({k: [(name, round(n * interval, 1)) for name, n in c.most_common(400)]
                       for k, c in seen.items()}, f, indent=0)

    def loop():
        last = time.monotonic()
        while True:
            time.sleep(interval)
            frame = sys._current_frames().get(main)
            stack = []
            while frame is not None:
                stack.append(frame)
                frame = frame.f_back
            if not stack:
                continue
            own = [f for f in reversed(stack) if f.f_code.co_filename in names]
            phases = [f.f_code.co_name for f in own if f.f_code.co_name.startswith("phase_")]
            seen["phase"][phases[0] if phases else own[-1].f_code.co_name if own else "?"] += 1
            if own:
                seen["chain"][">".join(f.f_code.co_name for f in own) + f":{own[-1].f_lineno}"] += 1
            leaf = stack[0]
            seen["leaf"][f"{os.path.basename(leaf.f_code.co_filename)}:{leaf.f_code.co_name}:"
                         f"{leaf.f_lineno}"] += 1
            repo = next((f for f in stack if f.f_code.co_filename != __file__ and (
                "dexbotic_tpu_torch" in f.f_code.co_filename
                or f"{os.sep}script{os.sep}" in f.f_code.co_filename)), None)
            if repo is not None:
                path = repo.f_code.co_filename
                path = path[path.find("dexbotic_tpu_torch") if "dexbotic_tpu_torch" in path
                            else path.find(f"script{os.sep}"):]
                seen["repo"][f"{path}:{repo.f_code.co_name}:{repo.f_lineno}"] += 1
            if time.monotonic() - last > 30:
                dump()
                last = time.monotonic()

    return loop, dump


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", help="the JSON file to write")
    ap.add_argument("script", help="the script to run")
    ap.add_argument("--interval", type=float, default=0.2, help="seconds between samples")
    args, rest = ap.parse_known_args()
    loop, dump = _sampler(args.out, args.script, args.interval)
    sys.path.insert(0, os.path.dirname(os.path.abspath(args.script)))
    sys.argv = [args.script, *rest]
    threading.Thread(target=loop, daemon=True).start()
    code = 0
    try:
        runpy.run_path(args.script, run_name="__main__")
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else (0 if e.code is None else 1)
    finally:
        dump()
    return code


if __name__ == "__main__":
    sys.exit(main())
