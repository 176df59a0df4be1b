"""Port attention (mpmc_tpu_torch/ops/attention.py) against the JAX
package's Pallas forward kernel run in TPU interpret mode, and against its
XLA path.  Inputs come from a numpy seed; both sides run in f32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mpmc_tpu.ops.attention import _attention_xla, _fwd_pallas
from mpmc_tpu_torch.ops import attention as A
from mpmc_tpu_torch.ops import build

# f32 on both sides: the two differ only in summation order and in where
# the 1/sqrt(D) scale is applied (q in the TPU kernel, the f32 scores here).
TOL = 1e-5


def _case(mode, B=2, Sq=16, Sk=16, H=2, D=16, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, H, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, H, D)).astype(np.float32)
    if mode == "padding":
        mask = np.ones((B, Sk), np.float32)
        mask[0, Sk // 2:] = 0
        mask[1:, :] = 0             # every query row of sample 1 fully masked
    elif mode == "segments":
        mask = np.zeros((B, Sk), np.float32)
        mask[0, :5], mask[0, 5:12] = 1, 2          # tail: segment 0 padding
        mask[1:, :9], mask[1:, 9:] = 3, 1
    else:
        mask = None
    return q, k, v, mask


CASES = [("padding", {}), ("segments", {}), ("none", {"Sk": 8}),
         ("padding", {"Sq": 8, "Sk": 24, "D": 8})]
# The long buckets (real manifests reach S = 512), which the bf16 kernel
# walks in several key blocks: B = H = 1 keeps interpret mode quick.
LONG = [("padding", {"B": 1, "H": 1, "Sq": 256, "Sk": 256, "D": 8}),
        ("segments", {"B": 1, "H": 1, "Sq": 256, "Sk": 256, "D": 8}),
        ("none", {"B": 1, "H": 1, "Sq": 40, "Sk": 256, "D": 16})]
LONG_IDS = ["padding-256", "segments-256", "none-40x256"]
# The card: the long buckets, D from 8 to 128, ragged Sq, a fully masked
# padding sample (sample 1) and a segment-0 tail (segments sample 0).
CUDA_CASES = CASES + [
    ("padding", {"D": 128}), ("none", {"Sq": 130, "D": 40}),
    ("padding", {"Sk": 256}), ("padding", {"Sq": 24, "Sk": 512, "D": 32}),
    ("segments", {"Sq": 256, "Sk": 256, "D": 64}),
    ("segments", {"Sq": 512, "Sk": 512, "D": 128}),
    ("none", {"Sq": 24, "Sk": 130, "D": 8}),
    ("padding", {"Sq": 100, "Sk": 128, "D": 32}),
    # The f32 kernel's tiles (128 queries, 64 keys): ragged S on both sides
    # of 128, ViT's 197 at D = 128, a packed row of many segments ending in
    # a segment-0 run, and the 4-byte copies (a row not 16-byte aligned,
    # D % 4 != 0), which the bf16 wrapper refuses.
    ("none", {"Sq": 127, "Sk": 129, "D": 16}),
    ("padding", {"Sq": 129, "Sk": 127, "D": 40}),
    ("padding", {"Sq": 17, "Sk": 197, "D": 32}),
    ("none", {"Sq": 197, "Sk": 197, "D": 128}),
    ("segments", {"Sq": 197, "Sk": 197, "D": 64, "packed": 12}),
    ("none", {"Sq": 70, "Sk": 129, "D": 64, "shift": 1}),
    ("padding", {"Sq": 33, "Sk": 70, "D": 6}),
    # The scratch captioner's f32 shapes: the decoder's cross-attention (24
    # queries over the 197 image tokens, 6 heads of the odd D = 21, which
    # the bf16 wrapper refuses) and its ViT encoder (4 heads of 32).
    ("none", {"Sq": 24, "Sk": 197, "H": 6, "D": 21}),
    ("none", {"Sq": 197, "Sk": 197, "H": 4, "D": 32})]


def _on_card(x, dtype, shift=0):
    """``x`` on the card in ``dtype``; ``shift`` > 0 gives a view that
    starts that many elements into its storage (rows not 16-byte
    aligned)."""
    t = torch.from_numpy(x).cuda().to(dtype)
    if not shift:
        return t
    flat = torch.empty(t.numel() + shift, dtype=dtype, device="cuda")
    view = flat[shift:].view(t.shape)
    view.copy_(t)
    return view


def packed_segments(B, S, n):
    """Segment ids of packed rows: ``n`` segments of S // (n + 1) tokens
    each, then a segment-0 run to the end of the row."""
    ids = np.repeat(np.arange(1, n + 1), S // (n + 1))
    row = np.zeros(S, np.float32)
    row[:ids.size] = ids
    return np.repeat(row[None], B, 0)


@pytest.mark.parametrize("mode,shape", CASES + LONG,
                         ids=["padding", "segments", "none-cross",
                              "padding-d8"] + LONG_IDS)
def test_plain_attention_matches_interpreted_pallas_kernel(mode, shape):
    q, k, v, mask = _case(mode, **shape)
    scale = 1.0 / np.sqrt(q.shape[-1])
    with pltpu.force_tpu_interpret_mode():
        want_out, want_lse = _fwd_pallas(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            None if mask is None else jnp.asarray(mask), mode, scale)
    got_out, got_lse = A.attention_forward_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if mask is None else torch.from_numpy(mask), mode)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               atol=TOL, rtol=TOL)
    # Fully masked query rows (every row of padding sample 1, the segment-0
    # tail of segments sample 0): the uniform average of all of V and
    # lse = -1e9, neither NaN nor zero from skipped keys.
    dead = {"padding": (1, slice(None)), "segments": (0, mask is not None
                                                      and mask[0] == 0)}
    if mode in dead and dead[mode][0] < q.shape[0]:
        b, rows = dead[mode]
        uniform = np.broadcast_to(v[b].mean(0), got_out.numpy()[b][rows].shape)
        np.testing.assert_allclose(got_out.numpy()[b][rows], uniform, atol=TOL)
        assert np.all(got_lse.numpy()[b][:, rows] == np.float32(-1e9))


@pytest.mark.parametrize("mode,shape", CASES,
                         ids=["padding", "segments", "none-cross", "padding-d8"])
def test_plain_attention_matches_xla_path(mode, shape):
    q, k, v, mask = _case(mode, seed=1, **shape)
    scale = 1.0 / np.sqrt(q.shape[-1])
    jm = None if mask is None else jnp.asarray(mask)
    want = _attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jm if mode == "padding" else None, scale,
                          segments=jm if mode == "segments" else None)
    tm = None if mask is None else torch.from_numpy(mask)
    got = A.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        tm if mode == "padding" else None,
        segments=tm if mode == "segments" else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


def test_plain_attention_rounds_e_to_the_input_dtype():
    """bf16: e is rounded before e.V, the row sum uses the unrounded e."""
    q, k, v, mask = _case("padding", seed=2)
    qb, kb, vb = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    out, _ = A.attention_forward_reference(qb, kb, vb, torch.from_numpy(mask))
    s = torch.einsum("bqhd,bkhd->bhqk", qb.float(), kb.float()) / 4.0
    s = s + ((1.0 - torch.from_numpy(mask)) * -1e9)[:, None, None, :]
    e = torch.exp(s - s.amax(-1, keepdim=True))
    want = (torch.einsum("bhqk,bkhd->bqhd", e.bfloat16().float(), vb.float())
            / e.sum(-1).permute(0, 2, 1)[..., None]).bfloat16()
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, want)


def test_wrapper_checks_shapes_and_never_falls_back():
    q, k, v, mask = _case("padding")
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    with pytest.raises(ValueError, match="self-attention"):
        A.attention_forward(tq, tk[:, :8], tv[:, :8],
                            torch.ones(2, 8), "segments")
    with pytest.raises(ValueError, match="mask"):
        A.attention_forward(tq, tk, tv, torch.ones(2, 5), "padding")
    with pytest.raises(ValueError, match="CUDA"):
        A.attention_forward_cuda(tq, tk, tv, torch.from_numpy(mask))


def test_bf16_layout_check_raises_on_what_cp_async_cannot_copy():
    """The bf16 kernels copy 16-byte chunks: D % 8 == 0 and 16-byte
    aligned rows, or the wrapper raises (f32 takes any layout)."""
    x = torch.zeros(2, 8, 2, 16, dtype=torch.bfloat16)
    A._check_bf16_layout("t", x, x, x)
    with pytest.raises(ValueError, match="D % 8"):
        y = torch.zeros(2, 8, 2, 12, dtype=torch.bfloat16)
        A._check_bf16_layout("t", y, y, y)
    flat = torch.zeros(2 * 8 * 2 * 16 + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(2, 8, 2, 16)
    with pytest.raises(ValueError, match="16-byte"):
        A._check_bf16_layout("t", x, shifted, x)
    wide = torch.zeros(2, 8, 2, 20, dtype=torch.bfloat16)[..., :16]
    with pytest.raises(ValueError, match="16-byte"):
        A._check_bf16_layout("t", wide, x, x)
    A._check_bf16_layout("t", *(t.float() for t in (x, shifted, wide)))


def test_library_name_follows_the_shared_headers(tmp_path, monkeypatch):
    """An edited csrc/*.cuh header gives a new library name, so the kernel
    that includes it is rebuilt (no nvcc needed to check the name)."""
    (tmp_path / "k.cu").write_text('#include "tiles.cuh"\n')
    (tmp_path / "tiles.cuh").write_text("// first\n")
    monkeypatch.setattr(build, "CSRC_DIR", str(tmp_path))
    first = build._lib_path("k")
    assert build._lib_path("k") == first
    (tmp_path / "tiles.cuh").write_text("// second\n")
    second = build._lib_path("k")
    assert second != first
    (tmp_path / "k.cu").write_text('#include "tiles.cuh"\n// edited\n')
    assert build._lib_path("k") not in (first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("mode,shape", CUDA_CASES)
def test_cuda_kernel_matches_plain_version(mode, shape, dtype, atol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    shape = dict(shape)
    shift, packed = shape.pop("shift", 0), shape.pop("packed", 0)
    q, k, v, mask = _case(mode, **shape)
    if packed:
        mask = packed_segments(q.shape[0], q.shape[1], packed)
    args = [_on_card(x, dtype, shift) for x in (q, k, v)]
    m = None if mask is None else torch.from_numpy(mask).cuda()
    if dtype == torch.bfloat16 and (shift or q.shape[-1] % 8):
        with pytest.raises(ValueError, match="bf16 kernel needs"):
            A.attention_forward_cuda(*args, m, mode)
        return
    before = A.launch_counts["attention_fwd"]
    out, lse = A.attention_forward_cuda(*args, m, mode)
    torch.cuda.synchronize()
    assert A.launch_counts["attention_fwd"] == before + 1
    ref_out, ref_lse = A.attention_forward_reference(*args, m, mode)
    torch.testing.assert_close(out.float(), ref_out.float(), atol=atol, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-5)


# ViT's sequences, 1 + (size / patch)^2 in mode none: 17 (the tests' tiny
# ViT), 50 (B/32 at 224), 197 (B/16 and L/16 at 224), 577 (at 384: the last
# 64-row tile holds one row) and the cap; H = 12 (ViT-B) and 16 (ViT-L).
VIT_CASES = [(17, 12), (50, 12), (197, 12), (577, 12), (577, 16), (1024, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("S,H", VIT_CASES)
def test_cuda_kernel_takes_vit_sequences(S, H, dtype, atol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    test_cuda_kernel_matches_plain_version(
        "none", {"Sq": S, "Sk": S, "H": H, "D": 64}, dtype, atol)


@pytest.mark.cuda
def test_cuda_entry_point_refuses_sequences_above_the_cap():
    """The C entry point returns cudaErrorInvalidValue (1) above the cap
    before it reads any pointer, whatever the wrapper lets through."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    lib = A._library()
    for Sq, Sk in ((A.MAX_SEQ + 1, 16), (16, A.MAX_SEQ + 1)):
        rc = lib.mpmc_attention_fwd(None, None, None, None, None, None, 1, 0,
                                    1, 1, Sq, Sk, 64, *([0] * 12), 0.125,
                                    None)
        assert rc == 1
