"""Stage-2 KD training against precomputed teacher top-K.

Traffic (the cell's traffic mix): ``batch`` rows of ``seq`` tokens a
step, ``accum`` microbatches, ``top_k`` teacher entries a position. Every
row is as long as the reference's truncation length (``seq``), so every
step does the same work. The seed draws every token id (a speech start
within the first 32 positions), the teacher's K distinct ids a position
and their float16 log-probabilities ~ N(-3, 1); the rows of
``pool_steps`` steps all differ, and the feed cycles through them.

The program: the config's ``Qwen3`` with the benchmark's seeded weights,
``distill/lora.init_lora`` (PiSSA), ``train_step.make_kd_step(mode=
"precomputed")`` with ``make_optimizer``, its batches collated by
``data/collator.DistillCollator`` and placed by ``core/prefetch``.
"""
from __future__ import annotations

import numpy as np

from benchmark.harness import training

SPEECH_BOS = 151_670          # a speech-start id of the speech vocabulary


def rows(cfg: dict, t: dict, seed: int, step: int) -> list:
    """The seeded feature rows of one step (the collator's input)."""
    V, K = cfg["vocab_size"], t["top_k"]
    pad, bos = cfg["eos_token_id"], t.get("speech_bos", SPEECH_BOS) % V
    rng = np.random.default_rng([seed % 2**63, step])
    L = t["seq"]
    feats = []
    for _ in range(t["batch"] * t.get("accum", 1)):
        ids = rng.integers(0, V, L)
        ids[(ids == pad) | (ids == bos)] = 1
        ids[int(rng.integers(1, min(32, L - 1)))] = bos
        cols = rng.permutation(V)[:K]
        feats.append({
            "input_ids": ids.tolist(),
            "teacher_top_k_v": (rng.standard_normal((L, K)) - 3).astype(
                np.float16),
            "teacher_top_k_i": ((rng.integers(0, V, (L, 1)) + cols) % V
                                ).astype(np.int32)})
    return feats


def reference_batch(cfg: dict, t: dict, feats: list) -> dict:
    """The reference's own collation: right padding to a multiple of
    ``pad_multiple`` with the EOS id, labels -100 at padding and before
    the first speech start."""
    bos = t.get("speech_bos", SPEECH_BOS) % cfg["vocab_size"]
    m = t["pad_multiple"]
    T = -(-max(len(f["input_ids"]) for f in feats) // m) * m
    B, K = len(feats), t["top_k"]
    ids = np.full((B, T), cfg["eos_token_id"], np.int64)
    mask = np.zeros((B, T), np.int64)
    top_v = np.zeros((B, T, K), np.float32)
    top_i = np.zeros((B, T, K), np.int64)
    labels = np.full((B, T), -100, np.int64)
    for b, f in enumerate(feats):
        n = len(f["input_ids"])
        ids[b, :n] = f["input_ids"]
        mask[b, :n] = 1
        top_v[b, :n] = f["teacher_top_k_v"]
        top_i[b, :n] = f["teacher_top_k_i"]
        start = f["input_ids"].index(bos)
        labels[b, start:n] = ids[b, start:n]
    return {"ids": ids, "mask": mask, "labels": labels, "top_v": top_v,
            "top_i": top_i}


class Program:
    """The program's KD step, state and feed, built from the seed."""

    def __init__(self, bench, fault: str = None):
        import dataclasses

        import torch
        from speech_distill_tpu_torch.core.config import (DistillConfig,
                                                          LoraConfig,
                                                          Qwen3Config)
        from speech_distill_tpu_torch.data.collator import DistillCollator
        from speech_distill_tpu_torch.distill import train_step
        from speech_distill_tpu_torch.distill.lora import init_lora

        from benchmark.harness.weights import load_program_model
        cfg, t = bench.config, bench.workload["traffic"]
        fields = {f.name for f in dataclasses.fields(Qwen3Config)}
        self.cfg = Qwen3Config(**{k: v for k, v in cfg.items()
                                  if k in fields})
        dev = torch.device(bench.device)
        self.model = load_program_model(self.cfg, cfg, bench.seed, dev)
        lcfg = LoraConfig(r=t["lora_r"], alpha=t["lora_alpha"])
        self.lora, self.base = init_lora(self.model, self.cfg, lcfg,
                                         device=dev)
        dcfg = DistillConfig(temperature=t["temperature"], alpha=t["alpha"],
                             top_k=t["top_k"], learning_rate=t["lr"],
                             lora=lcfg)
        opt = train_step.make_optimizer(t["lr"], t["warmup_steps"],
                                        t["total_steps"],
                                        max_grad_norm=t["max_grad_norm"])
        step = train_step.make_kd_step(self.cfg, dcfg, opt,
                                       mode="precomputed", device=dev)
        self.state = train_step.init_state(self.lora, opt)
        run = training.stepper(step, self.base, teacher_slot=True)
        if fault == "half_batch":
            half = t["batch"] // 2
            self.run_step = lambda s, b: run(
                s, {k: v[:, :half] for k, v in b.items()})
        elif fault == "unchanged":
            self.run_step = lambda s, b: training.unchanged(run, s, b)
        else:
            self.run_step = run
        collate = DistillCollator(pad_token_id=self.cfg.eos_token_id,
                                  speech_bos_id=t.get("speech_bos",
                                                      SPEECH_BOS) % cfg[
                                      "vocab_size"],
                                  pad_to_multiple_of=t["pad_multiple"])
        A, B = t.get("accum", 1), t["batch"]
        # the rows of ``pool_steps`` steps, made in set-up (a dataset on
        # disk costs the host nothing here); the feed cycles through them
        pool = [rows(cfg, t, bench.seed, i) for i in range(t["pool_steps"])]

        def make(i):
            big = collate(pool[i % len(pool)])
            return {k: v.reshape((A, B) + v.shape[1:])
                    for k, v in big.items()}
        self.feed = training.Feed(make, dev)
        self.tokens_per_step = A * B * t["seq"]


def reference(bench, precision: str = "fp32") -> dict:
    """The reference's readings of the first steps: the same weights,
    PiSSA, rows and optimizer worked out again in float32 (or, for the
    control, with float8 linear layers)."""
    import torch

    from benchmark.harness.weights import draw
    from benchmark.reference.qwen3 import Qwen3Ref, exact_fp32
    from benchmark.reference.train import (AdamW, kd_sums, lora_start,
                                           warmup_linear)
    exact_fp32()
    cfg, t = bench.config, bench.workload["traffic"]
    dev = torch.device(bench.device)
    w = draw(cfg, bench.seed, dev, getattr(torch, cfg["dtype"]))
    ref = Qwen3Ref(cfg, w)
    del w
    r, alpha_l = t["lora_r"], t["lora_alpha"]
    g = alpha_l / np.sqrt(r)
    targets = [("attn", "q"), ("attn", "k"), ("attn", "v"), ("attn", "o"),
               ("mlp", "gate"), ("mlp", "up"), ("mlp", "down")]
    ref.lora, ref.scale = lora_start(ref, targets, r, g, dev), float(g)
    embed = ref.w["embed"].clone().requires_grad_()
    params = {"embed.weight": embed}
    store = {"embed.weight": getattr(torch, cfg["dtype"])}
    for (group, key), (a, b) in ref.lora.items():
        params[f"layers.{group}.{key}.a"] = a
        params[f"layers.{group}.{key}.b"] = b
        store[f"layers.{group}.{key}.a"] = torch.float32
        store[f"layers.{group}.{key}.b"] = torch.float32
    start = {k: p.detach().clone() for k, p in params.items()}
    opt = AdamW(warmup_linear(t["lr"], t["warmup_steps"], t["total_steps"]),
                max_norm=t["max_grad_norm"])
    blk = t.get("ref_rows", 4)
    losses, grads = [], {}
    for i in range(t["check_steps"]):
        bt = reference_batch(cfg, t, rows(cfg, t, bench.seed, i))
        bt = {k: torch.as_tensor(v, device=dev) for k, v in bt.items()}
        denom = float((bt["labels"][:, 1:] != -100).sum().clamp_min(1))
        total = 0.0
        for r0 in range(0, bt["ids"].shape[0], blk):
            sl = slice(r0, r0 + blk)
            h = ref.hidden(bt["ids"][sl], bt["mask"][sl], embed=embed,
                           precision=precision)
            logits = ref.head(h, embed=embed, precision=precision)
            loss = kd_sums(logits, bt["labels"][sl], bt["top_v"][sl],
                           bt["top_i"][sl], denom, t["temperature"],
                           t["alpha"])
            loss.backward()
            total += float(loss.detach())
            del h, logits, loss
        losses.append(total)
        gr = {k: p.grad.detach().clone() for k, p in params.items()}
        if i == 0:
            grads = training.norms(split_layers(gr))
        norm = opt.step({k: p.data for k, p in params.items()}, gr, store)
        if i == 0:
            g_norm = norm
        for p in params.values():
            p.grad = None
    change = training.norms(split_layers(
        {k: p.detach() - start[k] for k, p in params.items()}))
    return {"loss": losses, "grad_norm": g_norm, "grad": grads,
            "change": change}


def split_layers(flat: dict) -> dict:
    """The reference's {dotted name: tensor} split per layer as
    :func:`training.named_leaves` names the program's leaves."""
    out = {}
    for k, v in flat.items():
        if k.startswith("layers."):
            for i in range(v.shape[0]):
                out[f"{k}[{i}]"] = v[i]
        else:
            out[k] = v
    return out


def run(bench, fault: str = None) -> dict:
    prog = Program(bench, fault)
    t = bench.workload["traffic"]
    state, readings = training.first_steps(
        prog.run_step, prog.state, prog.feed, t["max_grad_norm"],
        t["check_steps"])
    state, counters = training.window(bench, prog.run_step, state,
                                      prog.feed, prog.tokens_per_step)
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
        "shapes": {"B": t["batch"], "T": t["seq"], "A": t.get("accum", 1)},
    }
