"""PE and IDE of the port against nero_tpu.utils.encodings (atol 1e-5, f32)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nero_tpu.utils import encodings as J
from nero_tpu_torch.utils import encodings as T


@pytest.mark.parametrize("num_freqs", [4, 6, 8])
def test_positional_encode(num_freqs):
    x = np.random.default_rng(num_freqs).uniform(-1, 1, (64, 3)).astype(np.float32)
    ref = np.asarray(J.positional_encode(jnp.asarray(x), num_freqs))
    out = T.positional_encode(torch.from_numpy(x), num_freqs).numpy()
    assert out.shape[-1] == T.positional_encode_dim(3, num_freqs)
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("deg", [2, 4, 5])
@pytest.mark.parametrize("scalar_kappa", [False, True])
def test_integrated_dir_encode(deg, scalar_kappa):
    rng = np.random.default_rng(deg)
    d = rng.standard_normal((128, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    kappa = 0.3 if scalar_kappa else rng.uniform(0, 1, (128, 1)).astype(np.float32)
    kj = kappa if scalar_kappa else jnp.asarray(kappa)
    kt = kappa if scalar_kappa else torch.from_numpy(kappa)
    ref = np.asarray(J.integrated_dir_encode(jnp.asarray(d), kj, deg))
    out = T.integrated_dir_encode(torch.from_numpy(d), kt, deg).numpy()
    assert out.shape[-1] == T.ide_dim(deg) == J.ide_dim(deg)
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_ide_tables_match():
    for a, b in zip(J._ide_tables(5), T.ide_tables(5)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
