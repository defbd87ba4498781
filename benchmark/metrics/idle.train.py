"""The device during training: the share of the traced sub-window in
which no kernel, copy or set runs."""
MOVES = "train_tokens_per_s"
UNIT = "%"


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
