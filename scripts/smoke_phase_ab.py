#!/usr/bin/env python3
"""Phases of ``chip_smoke.py`` timed in two checkouts on one NVIDIA GPU, in
turns: how much a change to the smoke's depth saves, on one host.

    python3 scripts/smoke_phase_ab.py DIR [DIR ...] [--phases P ...]
                                      [--out FILE]

Each DIR is the root of a checkout of this repository; each runs in a
process of its own (its ``chip_smoke`` and ``speech_distill_tpu_torch``
imported from there, its kernels built there), in the order given, so
pass ``parent change change parent`` to see the drift between turns. A
process builds the kernels, draws the full-width 0.6B from the smoke's
seed where a phase needs it (not timed), then runs each phase as
``main()`` calls it and times it with the host clock after a
synchronise. A phase a checkout lacks is skipped. Phases: ``tts_serve``
(3c), ``decode_engines`` (3d), ``online_kd`` (9b), ``synthesis`` (16),
``parallel`` (18), ``remat`` (the remat policies after phase 9, on a
PiSSA LoRA of a fresh 0.6B) and ``dryrun`` (the multi-process dry run
after phase 18). A failing check fails the process, as in the smoke.

Prints one JSON line a DIR (and appends it to ``--out``): the card and
its power limit, and each phase's seconds; with ``--out`` each DIR's own
output (the phases' log lines) goes to ``FILE.<n>.log``, n its turn.
Imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

PHASES = ("tts_serve", "decode_engines", "online_kd", "synthesis",
          "parallel", "remat", "dryrun")
CALLED = {"remat": "remat_policies"}     # a phase's function, by name


def remat(cs, cfg, dev) -> None:
    model = cs.qwen3.init_params(cfg, seed=cs.SEED, device=dev)
    lora, base = cs.init_lora(model, cfg, cs.LoraConfig(), device=dev)
    cs.remat_policies(cfg, base, lora, dev)


def child(phases) -> dict:
    sys.path.insert(0, os.getcwd())
    import torch
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.record_card()
    cs.build_kernels()
    cfg = cs.qwen3_student_0p6b()
    model = None
    side = torch.cuda.Stream()
    calls = {"tts_serve": lambda: cs.tts_serve(cfg, model, dev),
             "decode_engines": lambda: cs.decode_engines(cfg, model, dev),
             "online_kd": lambda: cs.online_kd(cfg, dev),
             "synthesis": lambda: cs.synthesis(dev),
             "parallel": lambda: cs.parallel(dev, side),
             "remat": lambda: remat(cs, cfg, dev),
             "dryrun": lambda: cs.dryrun()}
    out = {"dir": os.getcwd(), "card": card, "seconds": {}}
    for name in phases:
        if not hasattr(cs, CALLED.get(name, name)):
            out["seconds"][name] = None           # not in this checkout
            continue
        if name in ("tts_serve", "decode_engines") and model is None:
            model = cs.qwen3.init_params(cfg, seed=cs.SEED, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        calls[name]()
        torch.cuda.synchronize()
        out["seconds"][name] = time.perf_counter() - t0
    return out


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("dirs", nargs="*")
    p.add_argument("--phases", nargs="+", default=list(PHASES),
                   choices=PHASES)
    p.add_argument("--out", default=None)
    p.add_argument("--child", action="store_true")
    args = p.parse_args()
    if args.child:
        print("PHASEAB " + json.dumps(child(args.phases)), flush=True)
        return
    for n, d in enumerate(args.dirs):
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             "--phases", *args.phases], cwd=os.path.abspath(d),
            capture_output=True, text=True)
        lines = [ln for ln in res.stdout.splitlines()
                 if ln.startswith("PHASEAB ")]
        if res.returncode != 0 or not lines:
            sys.stderr.write(res.stdout[-4000:] + res.stderr[-4000:])
            sys.exit(f"{d}: exit {res.returncode}")
        line = lines[-1][len("PHASEAB "):]
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
            with open(f"{args.out}.{n}.log", "w") as f:
                f.write(res.stdout)


if __name__ == "__main__":
    main()
