"""Stage 1: the new speech-token embedding rows warmed up by next-token
cross entropy over packed sequences, everything else frozen.

Traffic (the cell's traffic mix): ``batch`` x ``accum`` packed rows of
``seq`` tokens a step. Examples are a text prefix of ``text_len`` old
vocabulary ids followed by ``speech_len`` new-vocabulary speech ids and
the EOS id, packed end to end, so every row is full and every step does
the same work; the seed draws the lengths and the ids, and every step's
rows differ. The last ``new_tokens`` rows of the vocabulary are new.

The program: the config's ``Qwen3`` with the benchmark's seeded weights,
``train_step.make_stage1_step`` on the route ``pipelines/stage1.
fused_route`` picks (on the card: the fused CE through K2), the rows
packed by ``pipelines/stage1.pack_sequences`` and placed by
``core/prefetch``.
"""
from __future__ import annotations

import numpy as np

from benchmark.harness import training


def examples(cfg: dict, t: dict, seed: int, step: int, need: int) -> list:
    """Seeded examples of one step, at least ``need`` tokens with EOS."""
    V = cfg["vocab_size"]
    old = V - t["new_tokens"]
    rng = np.random.default_rng([seed % 2**63, step])
    out, total = [], 0
    while total < need:
        text = rng.integers(0, old, int(rng.integers(*t["text_len"])))
        speech = rng.integers(old, V, int(rng.integers(*t["speech_len"])))
        ex = np.concatenate([text, speech])
        ex[ex == cfg["eos_token_id"]] = 1
        out.append(ex.tolist())
        total += len(ex) + 1
    return out


def packed(cfg: dict, t: dict, seed: int, step: int) -> np.ndarray:
    """The reference's packing of a step: examples joined, each followed
    by the EOS id, cut into rows of ``seq``; the first ``batch * accum``."""
    n, T = t["batch"] * t["accum"], t["seq"]
    flat = []
    for ex in examples(cfg, t, seed, step, n * T):
        flat.extend(ex)
        flat.append(cfg["eos_token_id"])
    return np.asarray(flat[:n * T], np.int64).reshape(n, T)


def split_rows(old: int):
    """The embedding's old rows and new rows as two leaves."""
    def split(leaves: dict) -> dict:
        w = leaves.pop("embed.weight")
        return {**leaves, "embed.old": w[:old], "embed.new": w[old:]}
    return split


class Program:
    """The program's stage-1 step, state and feed, built from the seed."""

    def __init__(self, bench, fault: str = None):
        import dataclasses

        import torch
        from speech_distill_tpu_torch.core.config import Qwen3Config
        from speech_distill_tpu_torch.distill import train_step
        from speech_distill_tpu_torch.pipelines import stage1

        from benchmark.harness.weights import load_program_model
        cfg, t = bench.config, bench.workload["traffic"]
        fields = {f.name for f in dataclasses.fields(Qwen3Config)}
        self.cfg = Qwen3Config(**{k: v for k, v in cfg.items()
                                  if k in fields})
        dev = torch.device(bench.device)
        self.model = load_program_model(self.cfg, cfg, bench.seed, dev)
        self.old = cfg["vocab_size"] - t["new_tokens"]
        fused, backend = stage1.fused_route(t["seq"], dev,
                                            self.cfg.torch_dtype,
                                            self.cfg.hidden_size)
        opt = train_step.make_optimizer(t["lr"], t["warmup_steps"],
                                        t["total_steps"],
                                        weight_decay=t["weight_decay"],
                                        max_grad_norm=t["max_grad_norm"])
        # the fault "mask_broken": every row of the table trains
        frozen = 0 if fault == "mask_broken" else self.old
        step = train_step.make_stage1_step(self.cfg, opt, frozen,
                                           fused_loss=fused,
                                           fused_backend=backend,
                                           device=dev)
        trainable = {"embed": {"weight": self.model.embed.detach().clone()
                               .requires_grad_()}}
        self.state = train_step.init_state(trainable, opt)
        run = training.stepper(step, self.model, teacher_slot=False)
        if fault == "half_batch":
            half = t["batch"] // 2
            self.run_step = lambda s, b: run(
                s, {k: v[:, :half] for k, v in b.items()})
        elif fault == "unchanged":
            self.run_step = lambda s, b: training.unchanged(run, s, b)
        else:
            self.run_step = run
        A, B, T = t["accum"], t["batch"], t["seq"]

        def make(i):
            ex = examples(cfg, t, bench.seed, i, A * B * T)
            rows = stage1.pack_sequences(ex, T, self.cfg.eos_token_id)
            ids = rows[:A * B].reshape(A, B, T)
            return {"input_ids": ids, "attention_mask": np.ones_like(ids),
                    "labels": ids.astype(np.int64)}
        self.feed = training.Feed(make, dev)
        self.tokens_per_step = A * B * T


def reference(bench, precision: str = "fp32") -> dict:
    """The reference's readings of the first steps: the same weights and
    rows, the cross entropy's gradient of the embedding with the old rows'
    zeroed, clip and AdamW, in float32 (the control: float8 linear
    layers). Each row runs alone, its layers recomputed in the backward."""
    import torch

    from benchmark.harness.weights import draw
    from benchmark.reference.qwen3 import Qwen3Ref, exact_fp32
    from benchmark.reference.train import AdamW, ce_sums, warmup_linear
    exact_fp32()
    cfg, t = bench.config, bench.workload["traffic"]
    dev = torch.device(bench.device)
    w = draw(cfg, bench.seed, dev, getattr(torch, cfg["dtype"]))
    ref = Qwen3Ref(cfg, w)
    del w
    old = cfg["vocab_size"] - t["new_tokens"]
    embed = ref.w["embed"].clone().requires_grad_()
    start = embed.detach().clone()
    opt = AdamW(warmup_linear(t["lr"], t["warmup_steps"], t["total_steps"]),
                weight_decay=t["weight_decay"], max_norm=t["max_grad_norm"])
    store = {"embed.weight": getattr(torch, cfg["dtype"])}
    A = t["accum"]
    losses, grads = [], {}
    split = split_rows(old)
    for i in range(t["check_steps"]):
        rows = torch.as_tensor(packed(cfg, t, bench.seed, i), device=dev)
        total = 0.0
        for a in range(A):
            mb = rows[a * t["batch"]:(a + 1) * t["batch"]]
            denom = float(mb.shape[0] * (mb.shape[1] - 1))
            for r in range(mb.shape[0]):
                h = ref.hidden(mb[r:r + 1], None, embed=embed,
                               precision=precision, remat=True)
                logits = ref.head(h, embed=embed, precision=precision)
                loss = ce_sums(logits, mb[r:r + 1], denom) / A
                loss.backward()
                total += float(loss.detach())
                del h, logits, loss
        losses.append(total)
        g = embed.grad.detach().clone()
        g[:old] = 0.0
        if i == 0:
            grads = training.norms(split({"embed.weight": g}))
        norm = opt.step({"embed.weight": embed.data}, {"embed.weight": g},
                        store)
        if i == 0:
            g_norm = norm
        embed.grad = None
    change = training.norms(split({"embed.weight": embed.detach() - start}))
    return {"loss": losses, "grad_norm": g_norm, "grad": grads,
            "change": change}


def run(bench, fault: str = None) -> dict:
    prog = Program(bench, fault)
    t = bench.workload["traffic"]
    state, readings = training.first_steps(
        prog.run_step, prog.state, prog.feed, t["max_grad_norm"],
        t["check_steps"], split_rows(prog.old))
    state, counters = training.window(bench, prog.run_step, state,
                                      prog.feed, prog.tokens_per_step,
                                      trace_steps=1)
    prog.feed.close()
    del prog, state
    training.free_program()
    ref = reference(bench)
    checks = training.compare(readings, ref, bench.workload.get(
        "limits", {}))
    w = counters["window_s"]
    return {
        "end_to_end": {
            "train_tokens_per_s": counters["tokens"] / w,
            "train_peak_mem_gib": counters["memory_peak_bytes"] / 2**30},
        "counters": counters, "checks": checks,
        "attempted": counters["steps"], "failed": 0,
        "memory_peak_bytes": counters["memory_peak_bytes"],
        "shapes": {"B": t["batch"], "T": t["seq"], "A": t["accum"],
                   "new_tokens": t["new_tokens"]},
    }
