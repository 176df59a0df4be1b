"""Port image kernel and training augmentation (mpmc_tpu_torch/ops/
image_ops.py, mpmc_tpu_torch/image/augment.py) against the JAX package's
Pallas image kernel in interpret mode and its ``_rotate_shear``.  Images
and draws come from a numpy seed."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpmc_tpu.image.augment import _rotate_shear as j_rotate_shear
from mpmc_tpu.ops.image_ops import (
    fused_normalize_flip_brightness as j_fused)
from mpmc_tpu_torch.image.augment import (augment_draws, augment_with_draws,
                                          train_augment)
from mpmc_tpu_torch.ops import image_ops as I

# Same f32 operations in the same order on both sides.
TOL = 1e-6
# The rotation runs its weighted rolls in bf16 on both sides; XLA may fuse
# the roll-multiply-add chain and round fewer intermediates than PyTorch's
# one-op-at-a-time bf16, so a pixel can differ by a few bf16 ulps (one ulp
# is 7.8e-3 at |x| in [1, 2) and 1.6e-2 in [2, 2.7]).
TOL_ROTATE = 4 * 1.6e-2


def _images(seed=0, B=4, H=24, W=20):
    rng = np.random.default_rng(seed)
    u8 = rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)
    flip = np.array([True, False, True, False][:B])
    bright = rng.uniform(0.9, 1.1, B).astype(np.float32)
    angle = (rng.uniform(-15.0, 15.0, B) * math.pi / 180.0).astype(np.float32)
    return u8, flip, bright, angle


def test_plain_fused_pass_matches_interpreted_pallas_kernel():
    u8, flip, bright, _ = _images()
    bright[0] = 1.1                # some pixels clip at 1
    want = j_fused(jnp.asarray(u8), jnp.asarray(flip), jnp.asarray(bright),
                   interpret=True)
    got = I.fused_normalize_flip_brightness(
        torch.from_numpy(u8), torch.from_numpy(flip), torch.from_numpy(bright))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


def test_augment_with_draws_matches_jax_kernel_and_rotation():
    u8, flip, bright, angle = _images(seed=1, H=48, W=40)
    want = j_rotate_shear(
        j_fused(jnp.asarray(u8), jnp.asarray(flip), jnp.asarray(bright),
                interpret=True), jnp.asarray(angle), 15.0)
    got = augment_with_draws(torch.from_numpy(u8), torch.from_numpy(flip),
                             torch.from_numpy(bright),
                             torch.from_numpy(angle))
    assert got.dtype == torch.float32 and got.shape == u8.shape
    diff = np.abs(got.numpy() - np.asarray(want))
    assert diff.max() <= TOL_ROTATE
    # Most pixels agree exactly; a stray rounding is rare.
    assert np.mean(diff == 0) > 0.95


def test_train_augment_draws():
    gen = torch.Generator().manual_seed(0)
    flip, bright, angle = augment_draws(4096, gen)
    assert flip.dtype == torch.bool and 0.45 < flip.float().mean() < 0.55
    assert 0.9 <= bright.min() and bright.max() <= 1.1
    assert abs(float(bright.mean()) - 1.0) < 0.01
    lim = 15.0 * math.pi / 180.0
    assert -lim <= angle.min() and angle.max() <= lim
    # The same seed gives the same augmented batch.
    u8 = torch.from_numpy(_images()[0])
    a = train_augment(u8, torch.Generator().manual_seed(3))
    b = train_augment(u8, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)


def test_wrapper_checks_and_never_falls_back():
    u8, flip, bright, _ = _images()
    args = (torch.from_numpy(u8), torch.from_numpy(flip),
            torch.from_numpy(bright))
    with pytest.raises(ValueError, match="CUDA"):
        I.fused_normalize_flip_brightness_cuda(*args)
    with pytest.raises(ValueError, match="C = 3"):
        I.fused_normalize_flip_brightness(args[0][..., :1], *args[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 24, 20), (16, 224, 224)])
def test_cuda_kernel_matches_plain_version(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    B, H, W = shape
    rng = np.random.default_rng(2)
    u8 = torch.from_numpy(rng.integers(0, 256, (B, H, W, 3),
                                       dtype=np.uint8)).cuda()
    flip = torch.from_numpy(np.arange(B) % 2 == 0).cuda()
    bright = torch.from_numpy(rng.uniform(0.9, 1.1, B)
                              .astype(np.float32)).cuda()
    before = I.launch_counts["image_normalize"]
    got = I.fused_normalize_flip_brightness_cuda(u8, flip, bright)
    torch.cuda.synchronize()
    assert I.launch_counts["image_normalize"] == before + 1
    want = I.fused_normalize_flip_brightness_reference(u8, flip, bright)
    torch.testing.assert_close(got, want, atol=TOL, rtol=0)
