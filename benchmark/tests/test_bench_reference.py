"""The plain reference against the port's CPU path on a tiny Qwen3, in
float32: the forward, PiSSA's start, the KD and stage-1 losses and one
clip + AdamW update."""
import dataclasses

import numpy as np
import pytest
import torch

from benchmark.harness import core
from benchmark.harness.weights import draw, load_program_model
from benchmark.reference import train as rt
from benchmark.reference.qwen3 import Qwen3Ref

CFG = {**core.config("qwen3_0.6b_speech"), **core.TINY, "dtype": "float32"}


def port_cfg():
    from speech_distill_tpu_torch.core.config import Qwen3Config
    fields = {f.name for f in dataclasses.fields(Qwen3Config)}
    return Qwen3Config(**{k: v for k, v in CFG.items() if k in fields})


def ids(B=2, T=24, seed=0):
    return torch.as_tensor(np.random.default_rng(seed).integers(
        0, CFG["vocab_size"], (B, T)))


def test_forward_matches_the_port():
    from speech_distill_tpu_torch.models import qwen3
    model = load_program_model(port_cfg(), CFG, 7, torch.device("cpu"))
    ref = Qwen3Ref(CFG, draw(CFG, 7, "cpu", torch.float32))
    x = ids()
    mask = torch.ones_like(x)
    mask[1, 18:] = 0
    got = qwen3.forward(model, x, attention_mask=mask)
    want = ref.head(ref.hidden(x, mask))
    keep = mask.bool()
    assert torch.allclose(got[keep], want[keep], atol=2e-5, rtol=1e-4)


def test_pissa_matches_the_port():
    from speech_distill_tpu_torch.core.config import LoraConfig
    from speech_distill_tpu_torch.distill.lora import init_lora
    model = load_program_model(port_cfg(), CFG, 7, torch.device("cpu"))
    lora, base = init_lora(model, port_cfg(), LoraConfig(r=4, alpha=8),
                           device="cpu")
    ref = Qwen3Ref(CFG, draw(CFG, 7, "cpu", torch.float32))
    g = 8 / np.sqrt(4)
    out = rt.lora_start(ref, [("attn", "q"), ("mlp", "down")], 4, g, "cpu")
    a, b = out[("attn", "q")]
    assert torch.equal(a, lora["layers"]["attn"]["q"]["a"])
    assert torch.equal(b, lora["layers"]["attn"]["q"]["b"])
    assert torch.allclose(ref.w["mlp.down"][1], base.layers[1].mlp.down,
                          atol=1e-7)


def test_kd_sums_match_the_port():
    from speech_distill_tpu_torch.distill import losses
    g = torch.Generator().manual_seed(0)
    B, T, V, K = 2, 12, 50, 5
    logits = torch.randn(B, T, V, generator=g)
    labels = torch.randint(0, V, (B, T), generator=g)
    labels[0, :3] = -100
    v = torch.randn(B, T, K, generator=g) - 3
    i = torch.randint(0, V, (B, T, K), generator=g)
    want = losses.sparse_distill_loss(logits, v, i, labels, None, 2.0, 0.5)
    denom = float((labels[:, 1:] != -100).sum())
    got = sum(rt.kd_sums(logits[r:r + 1], labels[r:r + 1], v[r:r + 1],
                         i[r:r + 1], denom, 2.0, 0.5) for r in range(B))
    assert float(got) == pytest.approx(float(want.total), rel=1e-6)
    ce = rt.ce_sums(logits, labels, denom)
    assert float(ce) == pytest.approx(float(want.task), rel=1e-6)


def test_adamw_matches_the_port():
    from speech_distill_tpu_torch.distill import train_step
    g = torch.Generator().manual_seed(1)
    p0 = {"w": torch.randn(6, 4, generator=g)}
    grads = [{"w": torch.randn(6, 4, generator=g) * 3} for _ in range(3)]
    opt = train_step.make_optimizer(1e-2, 2, 50, weight_decay=0.01)
    port = {"w": p0["w"].clone()}
    st = opt.init(port)
    ref = {"w": p0["w"].clone()}
    ropt = rt.AdamW(rt.warmup_linear(1e-2, 2, 50), weight_decay=0.01)
    for gr in grads:
        ups, st = opt.update(gr, st, port)
        port = train_step.apply_updates(port, ups, in_place=False)
        ropt.step(ref, gr, {"w": torch.float32})
    assert torch.allclose(port["w"].detach(), ref["w"], atol=1e-6)
