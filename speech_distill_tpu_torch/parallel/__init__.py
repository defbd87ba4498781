"""Data, tensor, sequence and pipeline parallelism over
``torch.distributed`` (port of ``speech_distill_tpu/parallel``): one
process a device, every rank running the same host code and holding its
local shards as plain tensors (``mesh``, ``sharding``, ``multihost``,
``comm``); ring attention over sp lives in ``ops/ring_attention``, the
pipeline schedules over pp in ``pipeline``."""
