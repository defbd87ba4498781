"""PyTorch port, the multi-process dry run (``parallel/multihost_dryrun``)
on gloo ranks on the CPU, as JAX's ``test_multihost.py`` runs its own:
each rank holds the ring online-sparse KD step on the (dp, sp, tp) mesh
to one process's (loss rtol 1e-5; trainable atol 1e-5, rtol 1e-4), a
checkpoint round trip bit-equal and ``train_loop``'s 3 steps with its
saves and the primary's metrics, then reports ``MULTIHOST_OK``."""
import pytest

from speech_distill_tpu_torch.parallel import multihost_dryrun


def _check(lines, n, d):
    assert len(lines) == n * d
    for rank, line in enumerate(lines):
        assert line.startswith(f"{multihost_dryrun.OK_MARK} rank={rank}/")
        assert f"'dp': {n}," in line and f"'sp': {d // 2}," in line
        single, multi = (float(x.split()[0]) for x in
                         line.split("single=")[1].split("multihost="))
        assert abs(single - multi) <= 1e-5 * abs(single)


def test_multihost_dryrun_2x2_cpu():
    """2 processes x 2 ranks: dp 2 across the processes, tp 2 within."""
    _check(multihost_dryrun.launch(2, 2, device="cpu", timeout_s=300), 2, 2)


@pytest.mark.slow
def test_multihost_dryrun_2x4_cpu():
    """The full layout, 2 x 4 ranks: dp 2, sp 2 (the ring), tp 2."""
    _check(multihost_dryrun.launch(2, 4, device="cpu", timeout_s=600), 2, 4)
