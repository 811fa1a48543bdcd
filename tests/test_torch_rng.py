"""The port's PCG (pathtracer_cuda_interactive_tpu_torch/ops/rng.py) is
bit-exact with the JAX package's uint32 PCG: the same states and the same
float32 uniforms for the same (pixel, sample, seed)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pathtracer_cuda_interactive_tpu.ops import rng as jax_rng
from pathtracer_cuda_interactive_tpu_torch.ops import rng

LANES = 65536


@pytest.mark.parametrize("sample_start", [0, 7, 2 ** 20])
@pytest.mark.parametrize("seed", [1984, 0, 0xDEADBEEF])
def test_streams_bit_equal_to_jax(seed, sample_start):
    pix = np.arange(LANES, dtype=np.uint32)
    s_ref = jax_rng.seed_rays(jnp.asarray(pix), sample_start, seed)
    s = rng.seed_rays(torch.from_numpy(pix.astype(np.int32)), sample_start,
                      seed)
    np.testing.assert_array_equal(np.asarray(s_ref).view(np.int32),
                                  s.numpy())
    for _ in range(6):
        s_ref, u_ref = jax_rng.next_uniform(s_ref)
        s, u = rng.next_uniform(s)
        np.testing.assert_array_equal(np.asarray(s_ref).view(np.int32),
                                      s.numpy())
        np.testing.assert_array_equal(np.asarray(u_ref), u.numpy())


def test_tensor_sample_index_matches_int():
    pix = torch.arange(4096, dtype=torch.int32)
    by_int = rng.seed_rays(pix, 2 ** 31 + 5, 1984)
    by_tensor = rng.seed_rays(pix, torch.full_like(pix, 2 ** 31 + 5 - 2 ** 32),
                              1984)
    assert torch.equal(by_int, by_tensor)


def test_logical_shift_matches_numpy():
    x = np.random.default_rng(0).integers(0, 2 ** 32, 10000,
                                          dtype=np.uint64).astype(np.uint32)
    xt = torch.from_numpy(x.view(np.int32))
    for k in (1, 4, 8, 19, 22, 28, 31):
        np.testing.assert_array_equal(rng._srl(xt, k).numpy().view(np.uint32),
                                      x >> np.uint32(k))
    k = torch.from_numpy((x % 31 + 1).astype(np.int32))
    np.testing.assert_array_equal(
        rng._srl(xt, k).numpy().view(np.uint32),
        x >> (x % 31 + 1).astype(np.uint32))


def test_uniforms_in_unit_interval():
    s = rng.seed_rays(torch.arange(LANES, dtype=torch.int32), 3)
    for _ in range(4):
        s, u = rng.next_uniform(s)
        assert u.dtype == torch.float32
        assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
        assert abs(float(u.mean()) - 0.5) < 0.01
