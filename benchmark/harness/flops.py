"""Operation counts of the Qwen3 decoder that the mfu metrics divide by.

Only what the work requires is counted: a matrix product of m x k by
k x n is 2 m k n operations; causal attention of a query at context c is
4 c H Dh a layer (scores and values); recomputation (remat) and padding
beyond what the step is given are never counted twice."""


def layer_matmul(cfg: dict) -> float:
    """Forward operations a token in one layer's projections and MLP."""
    D, F = cfg["hidden_size"], cfg["intermediate_size"]
    Dh = cfg["head_dim"]
    QD, KVD = cfg["num_attention_heads"] * Dh, cfg["num_key_value_heads"] * Dh
    return 2.0 * (D * QD + 2 * D * KVD + QD * D + 3 * D * F)


def attention(cfg: dict, context: float) -> float:
    """Forward operations of one query at ``context`` keys in one layer."""
    return 4.0 * context * cfg["num_attention_heads"] * cfg["head_dim"]


def head(cfg: dict, rows: int = None) -> float:
    """The lm head's forward a token (``rows`` of the vocabulary)."""
    return 2.0 * cfg["hidden_size"] * (rows or cfg["vocab_size"])


def lora(cfg: dict, r: int) -> float:
    """Forward operations a token in one layer's seven rank-r adapters."""
    D, F = cfg["hidden_size"], cfg["intermediate_size"]
    Dh = cfg["head_dim"]
    QD, KVD = cfg["num_attention_heads"] * Dh, cfg["num_key_value_heads"] * Dh
    dims = [(D, QD), (D, KVD), (D, KVD), (QD, D), (D, F), (D, F), (F, D)]
    return sum(2.0 * r * (a + b) for a, b in dims)
