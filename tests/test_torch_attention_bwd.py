"""Port attention backward (mpmc_tpu_torch/ops/attention.py) against the JAX
package's Pallas backward kernel run in TPU interpret mode and against
``jax.vjp`` of its XLA path; autograd through ``dot_product_attention``.
Inputs come from a numpy seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mpmc_tpu.ops.attention import _attention_xla, _bwd_pallas, _fwd_pallas
from mpmc_tpu_torch.ops import attention as A
from test_torch_attention import _on_card, packed_segments

# f32 on both sides: the two sum in different orders.
TOL = 1e-5
# bf16: both round P and dS to bf16 at the same points (on the CPU the two
# agree exactly at these sizes), but a different f32 summation order, as on
# the card, can put a value on the other side of a bf16 rounding boundary;
# one bf16 ulp of a P or dS entry, or of an output near 2-4, is up to
# 1.6e-2 here (|q|, |k|, |v|, |dO| ~ 1, sums of 8 to 130 terms).
TOL_BF16 = 3e-2


def _case(mode, B=2, Sq=16, Sk=16, H=2, D=16, seed=0):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((B, Sq, H, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, Sk, H, D)).astype(np.float32)
            for _ in range(2))
    if mode == "padding":
        mask = np.ones((B, Sk), np.float32)
        mask[0, Sk // 2:] = 0
        mask[1:, :] = 0             # every query row of sample 1 fully masked
    elif mode == "segments":
        mask = np.zeros((B, Sk), np.float32)
        mask[0, :5], mask[0, 5:12] = 1, 2          # tail: segment-0 rows
        mask[1:, :9], mask[1:, 9:] = 3, 1
    else:
        mask = None
    return q, k, v, mask, do


CASES = [("padding", {}), ("padding", {"Sq": 8, "Sk": 24}), ("none", {}),
         ("none", {"Sk": 8}), ("segments", {})]
IDS = ["padding", "padding-cross", "none", "none-cross", "segments"]
# The long buckets (real manifests reach S = 512), which the bf16 kernels
# take in two launches over 64-row tiles: B = H = 1 keeps interpret mode
# quick.
LONG = [("padding", {"B": 1, "H": 1, "Sq": 256, "Sk": 256, "D": 8}),
        ("segments", {"B": 1, "H": 1, "Sq": 256, "Sk": 256, "D": 8}),
        ("none", {"B": 1, "H": 1, "Sq": 40, "Sk": 256, "D": 16})]
LONG_IDS = ["padding-256", "segments-256", "none-40x256"]
# The card: one launch at Sq, Sk <= 128 and two beyond, D from 8 to 128,
# ragged Sq, a fully masked padding sample (sample 1) and a segment-0 tail
# (segments sample 0).
CUDA_CASES = CASES + [
    ("padding", {"D": 128}), ("none", {"Sq": 130, "Sk": 70, "D": 40}),
    ("segments", {"Sq": 128, "Sk": 128, "D": 64}),
    ("padding", {"Sq": 24, "Sk": 128, "D": 8}),
    ("none", {"Sq": 100, "Sk": 120, "D": 32}),
    ("padding", {"Sk": 256}), ("padding", {"Sq": 24, "Sk": 512, "D": 32}),
    ("segments", {"Sq": 256, "Sk": 256, "D": 64}),
    ("segments", {"Sq": 512, "Sk": 512, "D": 128}),
    ("none", {"Sq": 200, "Sk": 8, "D": 8}),
    # The f32 kernels' 64-row tiles (see test_torch_attention.py): ragged S
    # on both sides of 64 and 128, ViT's 197 at D = 128, a packed row of
    # many segments ending in a segment-0 run, and the 4-byte copies.
    ("none", {"Sq": 127, "Sk": 129, "D": 16}),
    ("padding", {"Sq": 129, "Sk": 127, "D": 40}),
    ("padding", {"Sq": 17, "Sk": 197, "D": 32}),
    ("none", {"Sq": 197, "Sk": 197, "D": 128}),
    ("segments", {"Sq": 197, "Sk": 197, "D": 64, "packed": 12}),
    ("none", {"Sq": 70, "Sk": 129, "D": 64, "shift": 1}),
    ("padding", {"Sq": 33, "Sk": 70, "D": 6})]


def _jax_fwd_bwd(q, k, v, mask, do, mode, dtype):
    scale = 1.0 / np.sqrt(q.shape[-1])
    jq, jk, jv, jdo = (jnp.asarray(x).astype(dtype) for x in (q, k, v, do))
    jm = None if mask is None else jnp.asarray(mask)
    with pltpu.force_tpu_interpret_mode():
        out, lse = _fwd_pallas(jq, jk, jv, jm, mode, scale)
        dq, dk, dv, _ = _bwd_pallas(mode, scale, (jq, jk, jv, jm, out, lse),
                                    jdo)
    return out, lse, (dq, dk, dv)


def _torch(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x.astype(jnp.float32))).to(dtype)


@pytest.mark.parametrize("mode,shape", CASES + LONG, ids=IDS + LONG_IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_matches_interpreted_pallas_kernel(mode, shape,
                                                          dtype):
    q, k, v, mask, do = _case(mode, **shape)
    jdtype = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdtype = getattr(torch, dtype)
    out, lse, want = _jax_fwd_bwd(q, k, v, mask, do, mode, jdtype)
    # Both sides get the same q, k, v, out, lse and dO.
    got = A.attention_backward_reference(
        *(torch.from_numpy(x).to(tdtype) for x in (q, k, v)),
        None if mask is None else torch.from_numpy(mask), mode,
        _torch(out, tdtype), torch.from_numpy(np.array(lse)),
        torch.from_numpy(do).to(tdtype))
    tol = TOL if dtype == "float32" else TOL_BF16
    for g, w in zip(got, want):
        assert g.dtype == tdtype
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)),
                                   atol=tol, rtol=0)


@pytest.mark.parametrize("mode,shape", CASES, ids=IDS)
def test_autograd_through_dot_product_attention(mode, shape):
    """The gradient reaches q, k and v through AttentionFunction and equals
    the plain backward on the forward's own out and lse."""
    q, k, v, mask, do = _case(mode, seed=1, **shape)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tm = None if mask is None else torch.from_numpy(mask)
    out = A.dot_product_attention(
        tq, tk, tv, tm if mode == "padding" else None,
        segments=tm if mode == "segments" else None)
    out.backward(torch.from_numpy(do))
    ref_out, lse = A.attention_forward_reference(tq.detach(), tk.detach(),
                                                 tv.detach(), tm, mode)
    assert torch.equal(out.detach(), ref_out)
    want = A.attention_backward_reference(tq.detach(), tk.detach(),
                                          tv.detach(), tm, mode, ref_out,
                                          lse, torch.from_numpy(do))
    for t, w in zip((tq, tk, tv), want):
        assert t.grad is not None
        assert torch.equal(t.grad, w)
    # No graph under inference mode: predict's forward stays as it was.
    with torch.inference_mode():
        assert not A.dot_product_attention(tq, tk, tv, None).requires_grad


@pytest.mark.parametrize("mode,shape", CASES, ids=IDS)
def test_backward_matches_jax_grad_of_xla_path(mode, shape):
    """In f32 the kernel's gradients are those of the plain softmax
    attention, wherever a query row is not fully masked (there the padding
    mode's exp(s - lse) differs from a softmax by design, as on the TPU;
    the cotangent of those rows is zero here).  Segment-0 rows of packed
    rows take part: segments mode recomputes their softmax exactly."""
    q, k, v, mask, do = _case(mode, seed=2, **shape)
    if mode == "padding":
        do[mask.sum(1) == 0] = 0.0
    scale = 1.0 / np.sqrt(q.shape[-1])
    jm = None if mask is None else jnp.asarray(mask)

    def f(q_, k_, v_):
        return _attention_xla(q_, k_, v_, jm if mode == "padding" else None,
                              scale, segments=jm if mode == "segments"
                              else None)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tm = None if mask is None else torch.from_numpy(mask)
    out = A.dot_product_attention(
        tq, tk, tv, tm if mode == "padding" else None,
        segments=tm if mode == "segments" else None)
    out.backward(torch.from_numpy(do))
    for t, w in zip((tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=TOL,
                                   rtol=0)


def test_backward_wrapper_checks_and_never_falls_back():
    q, k, v, mask, do = _case("padding")
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = A.attention_forward_reference(tq, tk, tv,
                                             torch.from_numpy(mask))
    with pytest.raises(ValueError, match="CUDA"):
        A.attention_backward_cuda(tq, tk, tv, torch.from_numpy(mask),
                                  "padding", out, lse, tdo)
    with pytest.raises(ValueError, match="self-attention"):
        A.attention_backward(tq, tk[:, :8], tv[:, :8], torch.ones(2, 8),
                             "segments", out, lse, tdo)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, TOL_BF16)])
@pytest.mark.parametrize("mode,shape", CUDA_CASES)
def test_cuda_backward_matches_plain_version(mode, shape, dtype, atol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    tq, tk, tv, tm, tdo = _cuda_case(mode, shape, dtype)
    if dtype == torch.bfloat16 and (shape.get("shift") or tq.shape[-1] % 8):
        B, Sq, H, _ = tq.shape
        lse = torch.zeros(B, H, Sq, device="cuda")
        with pytest.raises(ValueError, match="bf16 kernel needs"):
            A.attention_backward_cuda(tq, tk, tv, tm, mode, tq, lse, tdo)
        return
    out, lse = A.attention_forward_cuda(tq, tk, tv, tm, mode)
    before = A.launch_counts["attention_bwd"]
    got = A.attention_backward_cuda(tq, tk, tv, tm, mode, out, lse, tdo)
    torch.cuda.synchronize()
    assert A.launch_counts["attention_bwd"] == before + 1
    want = A.attention_backward_reference(tq, tk, tv, tm, mode, out, lse,
                                          tdo)
    rtol = 0
    if dtype == torch.float32 and max(tq.shape[1], tk.shape[1]) > 130:
        # f32 sums of 256 to 512 terms in another order; the fully masked
        # sample's (P = 1 on every key) reach 16 and more.
        atol, rtol = 1e-4, 1e-5
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), atol=atol, rtol=rtol)


def _cuda_case(mode, shape, dtype):
    shape = dict(shape)
    shift, packed = shape.pop("shift", 0), shape.pop("packed", 0)
    q, k, v, mask, do = _case(mode, **shape)
    if mode == "segments" and shape.get("Sq") == 128:
        mask = np.repeat(np.arange(1, 9), 16)[None].repeat(2, 0)
        mask[:, 100:] = 0
        mask = mask.astype(np.float32)
    if packed:
        mask = packed_segments(q.shape[0], q.shape[1], packed)
    tq, tk, tv, tdo = (_on_card(x, dtype, shift) for x in (q, k, v, do))
    tm = None if mask is None else torch.from_numpy(mask).cuda()
    return tq, tk, tv, tm, tdo


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mode,shape", [
    ("segments", {"Sq": 128, "Sk": 128, "D": 64}), ("padding", {"D": 128}),
    ("segments", {"Sq": 256, "Sk": 256, "D": 64}),
    ("none", {"Sq": 197, "Sk": 197, "D": 64})])
def test_cuda_backward_is_bit_equal_across_runs(mode, shape, dtype):
    """No atomics: every gradient entry is summed by one thread (f32) or
    one warp (bf16) in one fixed order, so two runs give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    tq, tk, tv, tm, tdo = _cuda_case(mode, shape, dtype)
    out, lse = A.attention_forward_cuda(tq, tk, tv, tm, mode)
    first = A.attention_backward_cuda(tq, tk, tv, tm, mode, out, lse, tdo)
    second = A.attention_backward_cuda(tq, tk, tv, tm, mode, out, lse, tdo)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_autograd_launches_the_backward_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    q, k, v, mask, do = _case("segments")
    tq, tk, tv = (torch.from_numpy(x).cuda().requires_grad_()
                  for x in (q, k, v))
    before = dict(A.launch_counts)
    out = A.dot_product_attention(tq, tk, tv,
                                  segments=torch.from_numpy(mask).cuda())
    out.backward(torch.from_numpy(do).cuda())
    torch.cuda.synchronize()
    assert A.launch_counts["attention_fwd"] == before["attention_fwd"] + 1
    assert A.launch_counts["attention_bwd"] == before["attention_bwd"] + 1
    assert tq.grad is not None and torch.isfinite(tq.grad).all()


# ViT's sequences in mode none (see test_torch_attention.py): ragged last
# tiles of the two-launch path (197 = 3 x 64 + 5, 577 = 9 x 64 + 1), the
# one-launch path at 17 and 50, and the cap; H = 12 and 16.
VIT_CASES = [(17, 12), (50, 12), (197, 12), (577, 12), (577, 16), (1024, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, TOL_BF16)])
@pytest.mark.parametrize("S,H", VIT_CASES)
def test_cuda_backward_takes_vit_sequences(S, H, dtype, atol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    test_cuda_backward_matches_plain_version(
        "none", {"Sq": S, "Sk": S, "H": H, "D": 64}, dtype, atol)


@pytest.mark.cuda
def test_cuda_backward_entry_point_refuses_sequences_above_the_cap():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    lib = A._library_bwd()
    for Sq, Sk in ((A.MAX_SEQ + 1, 16), (16, A.MAX_SEQ + 1)):
        rc = lib.mpmc_attention_bwd(*([None] * 13), 1, 0, 1, 1, Sq, Sk, 64,
                                    0.125, None)
        assert rc == 1
