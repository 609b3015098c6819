"""The PyTorch port's flash-attention backward against the JAX package.

The same inputs and cotangents, made from a numpy seed, go through both
packages on the CPU: ``jax.vjp`` of the reference's custom-VJP functions
(``_flash``, ``_flash_seg``, ``flash_with_lse``), whose backward runs the
Pallas ``_dq_kernel``/``_dkv_kernel`` in interpret mode, and the port's
differentiable ``flash_attention_bhld``/``flash_with_lse``, whose backward on
CPU tensors runs the plain twins ``flash_bwd_dq_plain``/``flash_bwd_dkv_plain``.
The twins are also held against torch autograd through
``flash_attention_plain`` in fp64. The Hopper kernels themselves are held
against the twins on the card (``tests/test_torch_kernel_cuda.py``,
``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_on_k8s.ops import flash_attention as jfa
from tpu_on_k8s_torch.ops import flash_attention as pfa

# tiny shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores under the suite's timing-sensitive tests
torch.set_num_threads(1)

# fp32 gradients of O(1) size: the two packages run the same fp32 arithmetic
# in another order (tiled and online there, one pass here); the largest gap
# measured over test_grads_match_pallas is 3.0e-6 (gradients up to 1.4), the
# tolerance about three times that.
FP32_ATOL = 1e-5
# fp64 twins against fp64 autograd: the same function in double precision.
FP64_ATOL = 1e-10


def _inputs(b, h, hkv, l, d, seed=0):
    """q, k, v and the cotangents of o and lse."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, l, d), np.float32),
            rng.standard_normal((b, hkv, l, d), np.float32),
            rng.standard_normal((b, hkv, l, d), np.float32),
            rng.standard_normal((b, h, l, d), np.float32),
            rng.standard_normal((b, h, 1, l), np.float32))


def _segments(b, l, seed=1):
    """Three packed documents per row, boundaries drawn per row."""
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.integers(1, l, (b, 2)), axis=-1)
    pos = np.arange(l)[None]
    return ((pos >= cuts[:, :1]).astype(np.int32)
            + (pos >= cuts[:, 1:]).astype(np.int32))


def _jax_grads(q, k, v, g, causal, valid_len=0, segments=None):
    l = q.shape[2]
    args = tuple(jnp.asarray(x) for x in (q, k, v))
    if segments is None:
        fn = lambda q_, k_, v_: jfa._flash(q_, k_, v_, causal, l, l,
                                           valid_len)
    else:
        seg = jnp.asarray(segments)
        fn = lambda q_, k_, v_: jfa._flash_seg(q_, k_, v_, seg, causal, l, l,
                                               valid_len)
    _, vjp = jax.vjp(fn, *args)
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _port_grads(q, k, v, g, causal, valid_len=0, segments=None,
                dtype=torch.float32):
    qt, kt, vt = (torch.from_numpy(x).to(dtype).requires_grad_()
                  for x in (q, k, v))
    seg = None if segments is None else torch.from_numpy(segments)
    o = pfa.flash_attention_bhld(qt, kt, vt, causal, valid_len, seg)
    o.backward(torch.from_numpy(g).to(dtype))
    return [t.grad.float().numpy() for t in (qt, kt, vt)]


def _assert_close(got, want, atol):
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("l", [40, 136])
@pytest.mark.parametrize("rep", [1, 2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_grads_match_pallas(causal, rep, l):
    q, k, v, g, _ = _inputs(2, 4, 4 // rep, l, 32)
    _assert_close(_port_grads(q, k, v, g, causal),
                  _jax_grads(q, k, v, g, causal), FP32_ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_grads_valid_len_match_pallas(causal):
    q, k, v, g, _ = _inputs(1, 4, 2, 48, 32, seed=3)
    _assert_close(_port_grads(q, k, v, g, causal, valid_len=37),
                  _jax_grads(q, k, v, g, causal, valid_len=37), FP32_ATOL)


@pytest.mark.parametrize("rep", [1, 2])
@pytest.mark.parametrize("causal", [True, False])
def test_grads_segments_match_pallas(causal, rep):
    q, k, v, g, _ = _inputs(2, 4, 4 // rep, 40, 32, seed=2)
    seg = _segments(2, 40)
    _assert_close(_port_grads(q, k, v, g, causal, segments=seg),
                  _jax_grads(q, k, v, g, causal, segments=seg), FP32_ATOL)


@pytest.mark.parametrize("rep", [1, 2])
def test_lse_cotangent_matches_pallas(rep):
    """A loss on both outputs of ``flash_with_lse``: the lse cotangent folds
    into delta in both packages."""
    q, k, v, g, g_lse = _inputs(2, 4, 4 // rep, 40, 32, seed=4)
    l = q.shape[2]
    _, vjp = jax.vjp(lambda a, b, c: jfa.flash_with_lse(a, b, c, True, l, l),
                     *(jnp.asarray(x) for x in (q, k, v)))
    want = [np.asarray(x) for x in vjp((jnp.asarray(g), jnp.asarray(g_lse)))]
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o, lse = pfa.flash_with_lse(qt, kt, vt, True)
    torch.autograd.backward((o, lse), (torch.from_numpy(g),
                                       torch.from_numpy(g_lse)))
    _assert_close([t.grad.numpy() for t in (qt, kt, vt)], want, FP32_ATOL)


# The Hopper kernels' own head dims and tile edges (128-row query tiles, dq
# K/V tiles of 64 keys): L 127/129/257 around tile boundaries, valid_len 129
# one past a boundary, segment cuts at 120 and 136 straddling row 128. These
# are the twins that the kernels are held against on the card.
EDGE_CUTS = (120, 136)


def _segments_across_tile(b, l):
    pos = np.arange(l)[None].repeat(b, 0)
    return ((pos >= EDGE_CUTS[0]).astype(np.int32)
            + (pos >= EDGE_CUTS[1]).astype(np.int32))


@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("l", [127, 129, 257])
@pytest.mark.parametrize("d", [64, 128])
def test_grads_match_pallas_at_kernel_tiles(d, l, rep):
    q, k, v, g, _ = _inputs(1, 4, 4 // rep, l, d, seed=7)
    _assert_close(_port_grads(q, k, v, g, True),
                  _jax_grads(q, k, v, g, True), FP32_ATOL)


@pytest.mark.parametrize("mask", ["valid_len", "segments"])
@pytest.mark.parametrize("d", [64, 128])
def test_grads_masks_match_pallas_at_kernel_tiles(d, mask):
    """valid_len 129 and segments crossing row 128, at L 257, GQA rep 4."""
    q, k, v, g, _ = _inputs(1, 4, 1, 257, d, seed=8)
    kw = (dict(valid_len=129) if mask == "valid_len"
          else dict(segments=_segments_across_tile(1, 257)))
    _assert_close(_port_grads(q, k, v, g, True, **kw),
                  _jax_grads(q, k, v, g, True, **kw), FP32_ATOL)


# The dk/dv kernel's own tiles: 128-key blocks of two 64-key warpgroups,
# 64-row query tiles, the q-heads of a GQA group summed in order. L 127-129
# and 255 around those edges, rep 1, 2 and 4; the twin it is held against
# on the card, called directly, against the Pallas _dkv_kernel.
def _port_dkv(q, k, v, g, causal, valid_len=0, segments=None):
    qt, kt, vt, gt = (torch.from_numpy(x) for x in (q, k, v, g))
    seg = None if segments is None else torch.from_numpy(segments)
    o, lse = pfa.flash_with_lse_fwd(qt, kt, vt, causal, valid_len, seg)
    delta = (gt * o).sum(-1)[:, :, None, :]
    return [t.numpy() for t in pfa.flash_bwd_dkv(qt, kt, vt, gt, lse, delta,
                                                 causal, valid_len, seg)]


def _assert_dkv_close(got, want):
    for name, a, b in zip(("dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=FP32_ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("rep", [1, 2, 4])
@pytest.mark.parametrize("l", [127, 128, 129, 255])
def test_dkv_twin_matches_pallas_at_dkv_tiles(l, rep):
    q, k, v, g, _ = _inputs(1, 4, 4 // rep, l, 64, seed=10)
    _assert_dkv_close(_port_dkv(q, k, v, g, True),
                      _jax_grads(q, k, v, g, True)[1:])


@pytest.mark.parametrize("rep", [1, 2, 4])
@pytest.mark.parametrize("mask", ["valid_len", "segments"])
def test_dkv_twin_masks_match_pallas_at_dkv_tiles(mask, rep):
    """valid_len 129 (one key past a 128-key block) and segments cut across
    key row 128, at L 255."""
    q, k, v, g, _ = _inputs(1, 4, 4 // rep, 255, 64, seed=11)
    kw = (dict(valid_len=129) if mask == "valid_len"
          else dict(segments=_segments_across_tile(1, 255)))
    _assert_dkv_close(_port_dkv(q, k, v, g, True, **kw),
                      _jax_grads(q, k, v, g, True, **kw)[1:])


@pytest.mark.parametrize("d", [64, 128])
def test_bf16_grads_near_pallas_at_kernel_tiles(d):
    q, k, v, g, _ = _inputs(1, 4, 1, 257, d, seed=9)
    l = q.shape[2]
    bf = lambda x: jnp.asarray(x, jnp.bfloat16)
    _, vjp = jax.vjp(lambda a, b, c: jfa._flash(a, b, c, True, l, l, 0),
                     bf(q), bf(k), bf(v))
    want = [np.asarray(x, np.float32) for x in vjp(bf(g))]
    got = _port_grads(q, k, v, g, True, dtype=torch.bfloat16)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert np.abs(a - b).max() <= 2e-2 * np.abs(b).max(), name


@pytest.mark.parametrize("case", [
    dict(causal=True), dict(causal=False), dict(causal=True, rep=4),
    dict(causal=True, valid_len=29), dict(causal=False, segmented=True),
    dict(causal=True, segmented=True, rep=2), dict(causal=True, lse=True),
])
def test_twins_match_fp64_autograd(case):
    """The twins are the exact gradient of ``flash_attention_plain``: in
    fp64, against torch autograd through it (o's and lse's cotangents)."""
    rep = case.get("rep", 1)
    q, k, v, g, g_lse = (torch.from_numpy(x).double()
                         for x in _inputs(2, 4, 4 // rep, 36, 16, seed=5))
    seg = (torch.from_numpy(_segments(2, 36)) if case.get("segmented")
           else None)
    causal, valid = case["causal"], case.get("valid_len", 0)
    if not case.get("lse"):
        g_lse = None
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o, lse = pfa.flash_attention_plain(*leaves, causal, valid, seg)
    outs, cots = ((o,), (g,)) if g_lse is None else ((o, lse), (g, g_lse))
    want = torch.autograd.grad(outs, leaves, cots)
    o, lse = o.detach(), lse.detach()
    got = pfa.flash_bwd(q, k, v, o, lse, g, causal, valid, seg, g_lse)
    # the twins directly, from the delta flash_bwd forms
    delta = (g * o).sum(-1)[:, :, None, :] - (0 if g_lse is None else g_lse)
    dq = pfa.flash_bwd_dq_plain(q, k, v, g, lse, delta, causal, valid, seg)
    dk, dv = pfa.flash_bwd_dkv_plain(q, k, v, g, lse, delta, causal, valid,
                                     seg)
    for a, b, c in zip(got, (dq, dk, dv), want):
        assert a.dtype == torch.float64 and a.shape == c.shape
        torch.testing.assert_close(a, b, atol=0, rtol=0)
        torch.testing.assert_close(a, c, atol=FP64_ATOL, rtol=0)


def test_padded_rows_add_nothing():
    """Query rows past a valid length contribute exactly zero to dk/dv when
    their cotangent is zero, as the reference's sliced-off pad rows."""
    q, k, v, g, _ = (torch.from_numpy(x) for x in _inputs(1, 4, 2, 24, 16))
    g[:, :, 17:] = 0
    o, lse = pfa.flash_with_lse_fwd(q, k, v, True, 17)
    _, dk, dv = pfa.flash_bwd(q, k, v, o, lse, g, True, 17)
    o2, lse2 = pfa.flash_with_lse_fwd(q[:, :, :17], k[:, :, :17],
                                      v[:, :, :17], True)
    _, dk2, dv2 = pfa.flash_bwd(q[:, :, :17], k[:, :, :17], v[:, :, :17], o2,
                                lse2, g[:, :, :17], True)
    assert torch.equal(dk[:, :, 17:], torch.zeros_like(dk[:, :, 17:]))
    torch.testing.assert_close(dk[:, :, :17], dk2, atol=1e-6, rtol=0)
    torch.testing.assert_close(dv[:, :, :17], dv2, atol=1e-6, rtol=0)


def test_bf16_grads_near_pallas():
    """bf16 inputs: ds and p are rounded to bf16 before the products in
    both packages; the gradients agree to bf16 precision."""
    q, k, v, g, _ = _inputs(2, 4, 2, 136, 32, seed=6)
    l = q.shape[2]
    bf = lambda x: jnp.asarray(x, jnp.bfloat16)
    _, vjp = jax.vjp(lambda a, b, c: jfa._flash(a, b, c, True, l, l, 0),
                     bf(q), bf(k), bf(v))
    want = [np.asarray(x, np.float32) for x in vjp(bf(g))]
    got = _port_grads(q, k, v, g, True, dtype=torch.bfloat16)
    # |dq| reaches ~10 here; bf16 keeps 8 bits of mantissa (~4e-3 relative)
    # and the two packages round ds in different tiles and orders
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        scale = np.abs(b).max()
        assert np.abs(a - b).max() <= 2e-2 * scale, name


def test_cpu_tensors_run_the_twins_without_a_launch():
    q, k, v, g, _ = (torch.from_numpy(x) for x in _inputs(1, 4, 2, 24, 64))
    before = (pfa.launches, pfa.dq_launches, pfa.dkv_launches)
    o, lse = pfa.flash_with_lse_fwd(q, k, v, True)
    dq, dk, dv = pfa.flash_bwd(q, k, v, o, lse, g, True)
    assert (pfa.launches, pfa.dq_launches, pfa.dkv_launches) == before
    delta = (g * o).sum(-1)[:, :, None, :]
    assert torch.equal(dq, pfa.flash_bwd_dq_plain(q, k, v, g, lse, delta))
    assert all(torch.equal(a, b) for a, b in zip(
        (dk, dv), pfa.flash_bwd_dkv_plain(q, k, v, g, lse, delta)))


@pytest.mark.parametrize("bad, match", [
    (dict(do_len=20), "dO"), (dict(lse_len=20), "lse"),
    (dict(lse_dtype=torch.float64), "lse"), (dict(o_len=20), "o "),
])
def test_flash_bwd_rejects_malformed_inputs(bad, match):
    q = torch.zeros(1, 4, 24, 16)
    k = torch.zeros(1, 2, 24, 16)
    do = torch.zeros(1, 4, bad.get("do_len", 24), 16)
    o = torch.zeros(1, 4, bad.get("o_len", 24), 16)
    lse = torch.zeros(1, 4, 1, bad.get("lse_len", 24),
                      dtype=bad.get("lse_dtype", torch.float32))
    with pytest.raises(ValueError, match=match):
        pfa.flash_bwd(q, k, k, o, lse, do, True)
