"""The port's HiFi-GAN discriminators against the JAX package's.

Initial parameters bit for bit (v1 and v2, one seed); v2's logits and every
feature map of real and generated audio (1 x 1 x 4,096 samples) within
1e-4 of each map's largest |value| (float32 summation order); the head
counts of v1 and v2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polgen_rvc_tpu.models import discriminators as jax_disc
from polgen_rvc_tpu_torch.convert.params import params_to_torch
from polgen_rvc_tpu_torch.models import discriminators as disc
from test_torch_pipeline import one_intra_op_thread  # noqa: F401 (autouse)


def _audio(seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((1, 1, 4096)) * 0.1).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_init_params_equal_jax_bit_for_bit(version):
    ours = disc.init_discriminator_params(version=version, seed=3)
    theirs = jax_disc.init_discriminator_params(version=version, seed=3)
    assert jax.tree.structure(ours) == jax.tree.structure(theirs)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs)):
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
    n_heads = len(disc.PERIODS_V2 if version == "v2" else disc.PERIODS_V1)
    assert len(ours["p"]) == n_heads


def test_v2_logits_and_feature_maps_match_jax():
    params = jax_disc.init_discriminator_params(version="v2", seed=0)
    y, y_hat = _audio(0)
    want = jax_disc.multi_period_discriminator(params, jnp.asarray(y), jnp.asarray(y_hat),
                                               version="v2")
    with torch.inference_mode():
        got = disc.multi_period_discriminator(params_to_torch(params), torch.from_numpy(y),
                                              torch.from_numpy(y_hat), version="v2")
    assert [len(x) for x in got] == [len(x) for x in want] == [9] * 4
    assert len(jax.tree.leaves(want)) == len(jax.tree.leaves(list(got))) == 2 * (9 + 7 + 8 * 6)
    for ref, out in zip(jax.tree.leaves(want), jax.tree.leaves(list(got))):
        ref, out = np.asarray(ref), out.numpy()
        assert out.shape == ref.shape and out.dtype == np.float32
        assert np.abs(out - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("version,periods", [("v1", (2, 3, 5, 7, 11, 17)),
                                             ("v2", (2, 3, 5, 7, 11, 17, 23, 37))])
def test_head_counts(version, periods):
    """The S head and one P head per period, each with one feature map per
    conv and one for its post conv; real and generated alike."""
    assert (disc.PERIODS_V1 if version == "v1" else disc.PERIODS_V2) == periods
    params = params_to_torch(disc.init_discriminator_params(version=version, seed=1))
    y, y_hat = (torch.from_numpy(a[..., :1000]) for a in _audio(1))
    with torch.inference_mode():
        r, f, rf, ff = disc.multi_period_discriminator(params, y, y_hat, version=version)
    assert len(r) == len(f) == len(rf) == len(ff) == 1 + len(periods)
    assert [len(m) for m in rf] == [7] + [6] * len(periods) == [len(m) for m in ff]
    for logits in r + f:
        assert logits.shape[0] == 1 and logits.dim() == 2 and torch.isfinite(logits).all()
