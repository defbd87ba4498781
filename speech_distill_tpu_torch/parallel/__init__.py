"""Data and tensor parallelism over ``torch.distributed`` (port of
``speech_distill_tpu/parallel``): one process a device, every rank running
the same host code on the same inputs and holding its local shards as
plain tensors (``mesh``, ``sharding``, ``multihost``, ``comm``). Sequence
and pipeline parallelism are not ported (ROADMAP §1 item 11)."""
