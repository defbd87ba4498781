"""Input layer (``data/collator``, ``core/prefetch``): the mean time a
training step of the window waits for its batch, from the benchmark's
``data_wait`` span around ``next(feed)``."""
MOVES = "train_tokens_per_s"
UNIT = "ms"


def read(run):
    c = run.counters
    if not c.get("steps"):
        return None
    return 1e3 * c["data_wait_s"] / c["steps"]
