"""The whole training step (``distill/train_step``): its share of the
card's bf16 peak, window tokens/s times the operations a token requires.

Required a token: one forward (every layer's projections and MLP, the
adapters where LoRA trains, causal attention at the row's positions, the
head over the whole vocabulary); in the backward the activation gradients
through every layer and the head (attention's backward is twice its
forward); weight gradients only of weights that train: the adapters, and
of the head the rows that train (LoRA: every row of the trainable tied
copy; stage 1: the new rows alone). The embedding lookup's gradient is a
scatter and counts nothing. Recomputation under remat is not counted, so
the share cannot pass 100 % whatever implements a kernel."""
from benchmark.harness import flops
from benchmark.harness.peaks import BF16_FLOPS

MOVES = "train_tokens_per_s"
UNIT = "%"


def per_token(cfg: dict, traffic: dict) -> float:
    """Required operations a token at sequence length ``seq``."""
    T = traffic["seq"]
    L = cfg["num_hidden_layers"]
    mm = flops.layer_matmul(cfg)
    attn = flops.attention(cfg, (T + 1) / 2)       # mean causal context
    ad = flops.lora(cfg, traffic["lora_r"]) if "lora_r" in traffic else 0.0
    head = flops.head(cfg)
    trained_rows = (traffic["new_tokens"] if "new_tokens" in traffic
                    else cfg["vocab_size"])
    fwd = L * (mm + ad + attn) + head
    bwd_act = L * (mm + ad + 2 * attn) + head
    bwd_w = L * ad + flops.head(cfg, trained_rows)
    return fwd + bwd_act + bwd_w


def read(run):
    c = run.counters
    if not c.get("window_s"):
        return None
    rate = c["tokens"] / c["window_s"]
    return 100.0 * rate * per_token(run.config, run.traffic) / BF16_FLOPS
