"""The PyTorch port's flash-attention forward against the JAX Pallas kernel.

The same inputs, made from a numpy seed, go through both packages on the
CPU: the JAX ``_fwd`` and ``flash_attention`` run the Pallas kernel in
interpret mode; the port's ``flash_with_lse_fwd`` and ``flash_attention``
take CPU tensors and so run ``flash_attention_plain``. The Hopper kernel
itself is compared with the plain version on the card by
``tests/test_torch_kernel_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_on_k8s.ops import flash_attention as jfa
from tpu_on_k8s_torch.ops import flash_attention as pfa

# tiny shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores under the suite's timing-sensitive tests
torch.set_num_threads(1)

# fp32: the same fp32 arithmetic, summed in another order.
FP32_ATOL = 1e-5
# bf16: outputs carry ~3 significant digits, and the Pallas kernel rounds P
# to bf16 against a running max per block where the plain version rounds it
# once against the final max. lse stays fp32 in both.
BF16_ATOL = 2e-2
BF16_LSE_ATOL = 1e-3


def _qkv(b, h, hkv, l, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, l, d), np.float32),
            rng.standard_normal((b, hkv, l, d), np.float32),
            rng.standard_normal((b, hkv, l, d), np.float32))


def _segments(b, l, seed=1):
    """Three packed documents per row, boundaries drawn per row."""
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.integers(1, l, (b, 2)), axis=-1)
    pos = np.arange(l)[None]
    return ((pos >= cuts[:, :1]).astype(np.int32)
            + (pos >= cuts[:, 1:]).astype(np.int32))


def _pallas_fwd(q, k, v, causal, valid_len=0, segments=None, dtype=None):
    dtype = dtype or jnp.float32
    l = q.shape[2]
    o, lse = jfa._fwd(jnp.asarray(q, dtype), jnp.asarray(k, dtype),
                      jnp.asarray(v, dtype), causal, l, l, valid_len,
                      None if segments is None else jnp.asarray(segments))
    return np.asarray(o, np.float32), np.asarray(lse)


def _port_fwd(q, k, v, causal, valid_len=0, segments=None,
              dtype=torch.float32):
    o, lse = pfa.flash_with_lse_fwd(
        torch.from_numpy(q).to(dtype), torch.from_numpy(k).to(dtype),
        torch.from_numpy(v).to(dtype), causal, valid_len,
        None if segments is None else torch.from_numpy(segments))
    assert o.dtype == dtype and lse.dtype == torch.float32
    return o.float().numpy(), lse.numpy()


@pytest.mark.parametrize("l", [40, 136])
@pytest.mark.parametrize("rep", [1, 2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_fwd_matches_pallas(causal, rep, l):
    q, k, v = _qkv(2, 4, 4 // rep, l, 32)
    want_o, want_lse = _pallas_fwd(q, k, v, causal)
    got_o, got_lse = _port_fwd(q, k, v, causal)
    assert got_lse.shape == (2, 4, 1, l)
    np.testing.assert_allclose(got_o, want_o, atol=FP32_ATOL, rtol=0)
    np.testing.assert_allclose(got_lse, want_lse, atol=FP32_ATOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_fwd_segments_match_pallas(causal):
    q, k, v = _qkv(2, 4, 2, 40, 32, seed=2)
    seg = _segments(2, 40)
    want_o, want_lse = _pallas_fwd(q, k, v, causal, segments=seg)
    got_o, got_lse = _port_fwd(q, k, v, causal, segments=seg)
    np.testing.assert_allclose(got_o, want_o, atol=FP32_ATOL, rtol=0)
    np.testing.assert_allclose(got_lse, want_lse, atol=FP32_ATOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_fwd_valid_len_matches_pallas(causal):
    """Keys at positions ≥ valid_len are masked; the rows the reference's
    caller keeps (those below valid_len) agree."""
    q, k, v = _qkv(1, 4, 2, 48, 32, seed=3)
    want_o, want_lse = _pallas_fwd(q, k, v, causal, valid_len=37)
    got_o, got_lse = _port_fwd(q, k, v, causal, valid_len=37)
    np.testing.assert_allclose(got_o[:, :, :37], want_o[:, :, :37],
                               atol=FP32_ATOL, rtol=0)
    np.testing.assert_allclose(got_lse[..., :37], want_lse[..., :37],
                               atol=FP32_ATOL, rtol=0)


def test_fwd_bf16_matches_pallas():
    q, k, v = _qkv(2, 4, 2, 136, 32, seed=4)
    want_o, want_lse = _pallas_fwd(q, k, v, True, dtype=jnp.bfloat16)
    got_o, got_lse = _port_fwd(q, k, v, True, dtype=torch.bfloat16)
    np.testing.assert_allclose(got_o, want_o, atol=BF16_ATOL, rtol=0)
    np.testing.assert_allclose(got_lse, want_lse, atol=BF16_LSE_ATOL, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("segmented", [False, True])
@pytest.mark.parametrize("l", [37, 136])
def test_public_flash_attention_matches(l, segmented, dtype):
    """The [B, L, H, D] entry point with Hkv-head k/v: the reference pads a
    ragged L to ``padded_len`` and masks the tail; the port masks in place.
    The rows both return agree."""
    q, k, v = (x.transpose(0, 2, 1, 3) for x in _qkv(2, 4, 2, l, 32, seed=5))
    seg = _segments(2, l) if segmented else None
    jdt, tdt, atol = ((jnp.float32, torch.float32, FP32_ATOL)
                      if dtype == "float32"
                      else (jnp.bfloat16, torch.bfloat16, BF16_ATOL))
    want = jfa.flash_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        causal=True, segments=None if seg is None else jnp.asarray(seg))
    got = pfa.flash_attention(
        torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
        torch.from_numpy(v).to(tdt), causal=True,
        segments=None if seg is None else torch.from_numpy(seg))
    assert got.shape == (2, l, 4, 32) and got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


# The Hopper kernels' own head dims and tile edges: 128-row query tiles, K/V
# tiles of 128 keys (forward) and 64 (dq). L 127/129/257 put the ragged edge
# on either side of a tile boundary; valid_len 129 ends the keys one past a
# tile; the segment cuts at 120 and 136 straddle the 128-row boundary. These
# are the plain twins that the kernels are held against on the card.
EDGE_CUTS = (120, 136)


def _segments_across_tile(b, l):
    """Three documents per row, cut at EDGE_CUTS (the middle one crosses
    row 128)."""
    pos = np.arange(l)[None].repeat(b, 0)
    return ((pos >= EDGE_CUTS[0]).astype(np.int32)
            + (pos >= EDGE_CUTS[1]).astype(np.int32))


@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("l", [127, 129, 257])
@pytest.mark.parametrize("d", [64, 128])
def test_fwd_matches_pallas_at_kernel_tiles(d, l, rep):
    q, k, v = _qkv(1, 4, 4 // rep, l, d, seed=7)
    want_o, want_lse = _pallas_fwd(q, k, v, True)
    got_o, got_lse = _port_fwd(q, k, v, True)
    np.testing.assert_allclose(got_o, want_o, atol=FP32_ATOL, rtol=0)
    np.testing.assert_allclose(got_lse, want_lse, atol=FP32_ATOL, rtol=0)


@pytest.mark.parametrize("mask", ["valid_len", "segments"])
@pytest.mark.parametrize("d", [64, 128])
def test_fwd_masks_match_pallas_at_kernel_tiles(d, mask):
    """valid_len 129 and segments crossing row 128, at L 257, GQA rep 4."""
    q, k, v = _qkv(1, 4, 1, 257, d, seed=8)
    kw = (dict(valid_len=129) if mask == "valid_len"
          else dict(segments=_segments_across_tile(1, 257)))
    want_o, want_lse = _pallas_fwd(q, k, v, True, **kw)
    got_o, got_lse = _port_fwd(q, k, v, True, **kw)
    np.testing.assert_allclose(got_o, want_o, atol=FP32_ATOL, rtol=0)
    np.testing.assert_allclose(got_lse, want_lse, atol=FP32_ATOL, rtol=0)


@pytest.mark.parametrize("d", [64, 128])
def test_fwd_bf16_matches_pallas_at_kernel_tiles(d):
    q, k, v = _qkv(1, 4, 1, 257, d, seed=9)
    want_o, want_lse = _pallas_fwd(q, k, v, True, dtype=jnp.bfloat16)
    got_o, got_lse = _port_fwd(q, k, v, True, dtype=torch.bfloat16)
    np.testing.assert_allclose(got_o, want_o, atol=BF16_ATOL, rtol=0)
    np.testing.assert_allclose(got_lse, want_lse, atol=BF16_LSE_ATOL, rtol=0)


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 4, 2, 24, 64))
    before = pfa.launches
    o, lse = pfa.flash_with_lse_fwd(q, k, v, True)
    po, plse = pfa.flash_attention_plain(q, k, v, True)
    assert pfa.launches == before
    assert torch.equal(o, po) and torch.equal(lse, plse)


@pytest.mark.parametrize("bad, match", [
    (dict(k_heads=3), "GQA head mismatch"),
    (dict(valid_len=99), "valid_len"),
    (dict(k_len=20), "does not fit"),
    (dict(seg_len=20), "segments"),
])
def test_wrapper_rejects_malformed_inputs(bad, match):
    q = torch.zeros(1, 4, 24, 16)
    k = torch.zeros(1, bad.get("k_heads", 2), bad.get("k_len", 24), 16)
    seg = (torch.zeros(1, bad["seg_len"], dtype=torch.int32)
           if "seg_len" in bad else None)
    with pytest.raises(ValueError, match=match):
        pfa.flash_with_lse_fwd(q, k, k, True, bad.get("valid_len", 0), seg)

