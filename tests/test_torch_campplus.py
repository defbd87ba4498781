"""PyTorch port, CAM++ (``models/campplus.py``) against the JAX package at
the published config (``CampPlusConfig()``) on the weights of the torch
oracle of ``tests/test_campplus.py`` (random BatchNorm statistics): the
oracle's ``state_dict()`` loads into the port by name, as a
``campplus.pt`` would; x-vectors at T 73, 187 and 400 frames, a
mixed-length batch (each row at its own length) and
``make_spk_emb_fn`` within 1e-4 relative (max |port - JAX| / max |JAX|)
of JAX's bucketed, masked forward; the JAX tree carried across by
``campplus_params_from_jax`` gives the same model. CPU, fp32."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from speech_distill_tpu.models import campplus as jc
from speech_distill_tpu_torch.models import campplus as tc
from speech_distill_tpu_torch.models.convert import campplus_params_from_jax
from tests.test_campplus import _randomize_bn_stats

REL_TOL = 1e-4
J_FORWARD = jax.jit(jc.forward)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """(JAX params, port CAMPPlus loaded from the oracle's state dict)."""
    from tests.oracles.campplus_torch import CAMPPlus
    torch.manual_seed(0)
    oracle = _randomize_bn_stats(CAMPPlus().eval())
    state = oracle.state_dict()
    return (jc.convert_torch_state(state),
            tc.from_state_dict(state, device="cpu"))


def rel_err(got, ref) -> float:
    return float(np.abs(got - ref).max() / np.abs(ref).max())


SINGLE = [73, 187, 400]
MIXED = [150, 320, 400]
SPK = 233


@pytest.fixture(scope="module")
def cases(pair):
    """Every test's seeded fbank features and JAX's x-vectors for them,
    from ONE masked JAX batch padded to 400 frames (one compile; the
    masking makes each row its own length's computation)."""
    params, _ = pair
    feats = {t: np.random.default_rng(t).normal(size=(t, 80)).astype(
        np.float32) for t in SINGLE + [SPK]}
    rng = np.random.default_rng(7)
    mixed = [rng.normal(size=(t, 80)).astype(np.float32) for t in MIXED]
    rows = [feats[t] for t in SINGLE + [SPK]] + mixed
    padded = np.zeros((len(rows), 400, 80), np.float32)
    for i, f in enumerate(rows):
        padded[i, :len(f)] = f
    lens = [len(f) for f in rows]
    ref = np.asarray(J_FORWARD(params, jnp.asarray(padded),
                               jnp.asarray(lens, np.int32)))
    n = len(SINGLE) + 1
    return ({t: (feats[t], ref[i]) for i, t in enumerate(SINGLE + [SPK])},
            (mixed, ref[n:]))


@pytest.mark.parametrize("t", SINGLE)
def test_xvector_matches_jax(pair, cases, t):
    _, model = pair
    feat, ref = cases[0][t]
    got = tc.embed_one(model, torch.from_numpy(feat)).numpy()
    assert got.shape == (192,)
    assert rel_err(got, ref) <= REL_TOL


def test_mixed_length_batch_matches_jax(pair, cases):
    """One right-padded batch of lengths 150, 320, 400 through the port's
    ``forward``, each row against JAX's masked batch row."""
    _, model = pair
    feats, ref = cases[1]
    padded = np.zeros((3, 400, 80), np.float32)
    for i, f in enumerate(feats):
        padded[i, :len(f)] = f
    got = tc.forward(model, torch.from_numpy(padded), MIXED).numpy()
    for g, r in zip(got, ref):
        assert rel_err(g, r) <= REL_TOL


def test_spk_emb_fn_and_jax_tree(pair, cases):
    """``make_spk_emb_fn`` (numpy in, numpy out) gives JAX's x-vector,
    and the model carried from the JAX tree holds the same weights."""
    params, model = pair
    feat, ref = cases[0][SPK]
    got = tc.make_spk_emb_fn(model, "cpu")(feat)
    assert isinstance(got, np.ndarray) and rel_err(got, ref) <= REL_TOL
    carried = campplus_params_from_jax(jax.tree.map(np.asarray, params),
                                       tc.CampPlusConfig(), "cpu")
    state = carried.state_dict()
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(state[k], v), k
