"""The port's Hopper kernels against their plain versions, on the card: the
flash-attention forward (``flash_fwd``) and backward kernels
(``flash_bwd_dq``, ``flash_bwd_dkv``), the int8 GEMM (``int8_matmul``) and
the quantize / dequantize kernels.

Every test here needs a CUDA card and nvcc, and skips without them. The
file imports neither JAX nor the JAX package, so that it also runs on a
machine with a card and no JAX::

    python -m pytest --noconftest -m cuda tests/test_torch_kernel_cuda.py
"""
import numpy as np
import pytest
import torch

from tpu_on_k8s_torch.ops import flash_attention as fa
from tpu_on_k8s_torch.ops import int8_matmul as i8
from tpu_on_k8s_torch.ops import quantization as quant

pytestmark = pytest.mark.cuda

# bf16 outputs carry ~3 significant digits, and the kernel rounds P to bf16
# per 64-key tile against a running max; lse is fp32 from fp32 scores. fp32
# differs only in summation order.
TOL = {torch.bfloat16: (2e-2, 1e-3), torch.float32: (1e-4, 1e-4)}
# Backward, as max|kernel - plain| / max|plain| per gradient: bf16 gradients
# are stored with 8 bits of mantissa (4e-3 of the largest value), and ds and
# p round to bf16 from fp32 values summed in another order than the plain
# version's; fp32 differs only in summation order.
BWD_REL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")


def _qkv(b, h, hkv, l, d, dtype, seed=6):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape, np.float32))
                 .to("cuda", dtype)
                 for shape in ((b, h, l, d), (b, hkv, l, d), (b, hkv, l, d)))


def _segments(b, l, seed=1):
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.integers(1, l, (b, 2)), axis=-1)
    pos = np.arange(l)[None]
    seg = (pos >= cuts[:, :1]).astype(np.int32) + (pos >= cuts[:, 1:])
    return torch.from_numpy(seg.astype(np.int32)).cuda()


@pytest.mark.parametrize("dtype, d, causal, l, valid, segmented", [
    (torch.bfloat16, 128, True, 333, 0, False),
    (torch.bfloat16, 128, False, 200, 0, True),
    (torch.bfloat16, 64, True, 512, 400, False),
    (torch.float32, 128, True, 333, 0, True),
    (torch.float32, 64, False, 130, 100, False),
])
def test_kernel_matches_plain(cuda, dtype, d, causal, l, valid, segmented):
    q, k, v = _qkv(2, 32, 8, l, d, dtype)
    seg = _segments(2, l) if segmented else None
    before = fa.launches
    o, lse = fa.flash_with_lse_fwd(q, k, v, causal, valid, seg)
    po, plse = fa.flash_attention_plain(q, k, v, causal, valid, seg)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert o.dtype == dtype and lse.shape == (2, 32, 1, l)
    assert (o.float() - po.float()).abs().max().item() <= TOL[dtype][0]
    assert (lse - plse).abs().max().item() <= TOL[dtype][1]


@pytest.mark.parametrize("b, l", [(4, 512), (1, 333)])
def test_layout_wrapper_reads_strided_views(cuda, b, l):
    """The serving path's call: contiguous [B, L, H, D] projections, which
    the kernel reads as strided [B, H, L, D] views."""
    q, k, v = (t.transpose(1, 2).contiguous()
               for t in _qkv(b, 32, 8, l, 128, torch.bfloat16))
    got = fa.flash_attention(q, k, v, causal=True)
    views = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    _, lse = fa.flash_with_lse_fwd(*views, True)
    want, plse = fa.flash_attention_plain(*views, True)
    assert got.shape == (b, l, 32, 128)
    tol_o, tol_lse = TOL[torch.bfloat16]
    assert (got.float() - want.transpose(1, 2).float()).abs().max().item(
        ) <= tol_o
    assert (lse - plse).abs().max().item() <= tol_lse


@pytest.mark.parametrize("dtype, d, match", [
    (torch.float16, 128, "bfloat16 or float32"),
    (torch.bfloat16, 96, "head dim"),
])
def test_kernel_refuses_what_it_does_not_take(cuda, dtype, d, match):
    q, k, v = _qkv(1, 4, 2, 64, d, dtype)
    before = fa.launches
    with pytest.raises(ValueError, match=match):
        fa.flash_with_lse_fwd(q, k, v, True)
    assert fa.launches == before


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def _plain_bwd(q, k, v, o, lse, do, causal, valid, seg):
    delta = (do.float() * o.float()).sum(-1)[:, :, None, :]
    dq = fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, valid, seg)
    dk, dv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, valid,
                                    seg)
    return dq, dk, dv


@pytest.mark.parametrize("dtype, d, h, hkv, causal, l, valid, segmented", [
    (torch.bfloat16, 128, 32, 8, True, 333, 0, False),
    (torch.bfloat16, 128, 16, 8, False, 200, 0, True),
    (torch.bfloat16, 64, 16, 16, True, 512, 400, False),
    (torch.bfloat16, 128, 16, 4, True, 256, 0, True),
    (torch.float32, 128, 32, 8, True, 333, 0, True),
    (torch.float32, 64, 16, 4, False, 130, 100, False),
])
def test_backward_kernels_match_plain(cuda, dtype, d, h, hkv, causal, l,
                                      valid, segmented):
    q, k, v = _qkv(2, h, hkv, l, d, dtype)
    do = _qkv(2, h, h, l, d, dtype, seed=7)[0]
    seg = _segments(2, l) if segmented else None
    o, lse = fa.flash_with_lse_fwd(q, k, v, causal, valid, seg)
    before = (fa.dq_launches, fa.dkv_launches)
    got = fa.flash_bwd(q, k, v, o, lse, do, causal, valid, seg)
    want = _plain_bwd(q, k, v, o, lse, do, causal, valid, seg)
    torch.cuda.synchronize()
    assert (fa.dq_launches, fa.dkv_launches) == (before[0] + 1, before[1] + 1)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape, name
        assert _rel_err(a, b) <= BWD_REL_TOL[dtype], name


def _segments_across_tile(b, l):
    """Three documents per row cut at rows 120 and 136 (across row 128)."""
    pos = torch.arange(l, device="cuda")
    return ((pos >= 120).int() + (pos >= 136).int()).to(
        torch.int32)[None].repeat(b, 1)


# The bf16 forward and dq kernels at their tile edges: 128-row query tiles,
# K/V tiles of 128 keys (forward) and 64 (dq).
@pytest.mark.parametrize("d, l, hkv, causal, valid, segmented", [
    *[(d, l, 2, True, 0, False) for d in (64, 128)
      for l in (127, 128, 129, 255, 2047)],
    (64, 255, 1, True, 129, False), (128, 255, 1, True, 129, False),
    (64, 255, 2, True, 0, True), (128, 255, 2, True, 0, True),
    (128, 300, 4, False, 0, True),
])
def test_sm90_kernels_at_tile_edges(cuda, d, l, hkv, causal, valid,
                                    segmented):
    q, k, v = _qkv(1, 4, hkv, l, d, torch.bfloat16)
    do = _qkv(1, 4, 4, l, d, torch.bfloat16, seed=7)[0]
    seg = _segments_across_tile(1, l) if segmented else None
    o, lse = fa.flash_with_lse_fwd(q, k, v, causal, valid, seg)
    po, plse = fa.flash_attention_plain(q, k, v, causal, valid, seg)
    delta = (do.float() * o.float()).sum(-1)[:, :, None, :]
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal, valid, seg)
    pdq = fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, valid, seg)
    torch.cuda.synchronize()
    tol_o, tol_lse = TOL[torch.bfloat16]
    assert (o.float() - po.float()).abs().max().item() <= tol_o
    assert (lse - plse).abs().max().item() <= tol_lse
    assert _rel_err(dq, pdq) <= BWD_REL_TOL[torch.bfloat16]


# The bf16 dk/dv kernel at its tile edges: 128-key blocks of two 64-key
# warpgroups, 64-row query tiles, the q-heads of a GQA group (rep 1, 2, 4)
# summed in order in bf16.
@pytest.mark.parametrize("d, l, hkv, valid, segmented", [
    *[(d, l, hkv, 0, False) for d in (64, 128)
      for l in (63, 64, 65, 127, 128, 129, 255, 2047) for hkv in (4, 2, 1)],
    *[(d, 255, hkv, 129, False) for d in (64, 128) for hkv in (4, 1)],
    *[(d, 255, hkv, 0, True) for d in (64, 128) for hkv in (4, 2)],
])
def test_dkv_kernel_at_tile_edges(cuda, d, l, hkv, valid, segmented):
    q, k, v = _qkv(1, 4, hkv, l, d, torch.bfloat16)
    do = _qkv(1, 4, 4, l, d, torch.bfloat16, seed=7)[0]
    seg = _segments_across_tile(1, l) if segmented else None
    o, lse = fa.flash_with_lse_fwd(q, k, v, True, valid, seg)
    delta = (do.float() * o.float()).sum(-1)[:, :, None, :]
    before = fa.dkv_launches
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, True, valid, seg)
    again = fa.flash_bwd_dkv(q, k, v, do, lse, delta, True, valid, seg)
    pdk, pdv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, True, valid,
                                      seg)
    torch.cuda.synchronize()
    assert fa.dkv_launches == before + 2
    assert _rel_err(dk, pdk) <= BWD_REL_TOL[torch.bfloat16]
    assert _rel_err(dv, pdv) <= BWD_REL_TOL[torch.bfloat16]
    assert torch.equal(dk, again[0]) and torch.equal(dv, again[1])


@pytest.mark.parametrize("l, segmented", [(2048, False), (255, True)])
def test_sm90_kernels_repeat_bit_for_bit(cuda, l, segmented):
    """No atomics: two launches of the forward, dq and dk/dv kernels on the
    same inputs agree to the bit."""
    q, k, v = _qkv(2, 16, 16, l, 128, torch.bfloat16)
    do = _qkv(2, 16, 16, l, 128, torch.bfloat16, seed=7)[0]
    seg = _segments_across_tile(2, l) if segmented else None
    runs = []
    for _ in range(2):
        o, lse = fa.flash_with_lse_fwd(q, k, v, True, 0, seg)
        delta = (do.float() * o.float()).sum(-1)[:, :, None, :]
        runs.append((o, lse, fa.flash_bwd_dq(q, k, v, do, lse, delta, True,
                                             0, seg),
                     *fa.flash_bwd_dkv(q, k, v, do, lse, delta, True, 0,
                                       seg)))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_autograd_runs_the_kernels_on_model_layout(cuda):
    """The training path's call: [B, L, H, D] projections read as strided
    [B, H, L, D] views, a non-contiguous dO, gradients through autograd."""
    b, l, h, hkv, d = 2, 333, 16, 8, 128
    q, k, v = (t.transpose(1, 2).contiguous().requires_grad_()
               for t in _qkv(b, h, hkv, l, d, torch.bfloat16))
    g = _qkv(b, h, h, l, d, torch.bfloat16, seed=8)[0]
    g = g.transpose(1, 2).contiguous()                 # [B, L, H, D]
    before = (fa.launches, fa.dq_launches, fa.dkv_launches)
    o = fa.flash_attention(q, k, v, causal=True)
    o.backward(g)
    assert (fa.launches, fa.dq_launches, fa.dkv_launches) == tuple(
        n + 1 for n in before)
    views = [t.detach().transpose(1, 2) for t in (q, k, v)]
    po, plse = fa.flash_with_lse_fwd(*views, True)
    want = _plain_bwd(*views, po, plse, g.transpose(1, 2), True, 0, None)
    tol = BWD_REL_TOL[torch.bfloat16]
    for name, a, w in zip(("dq", "dk", "dv"), (q.grad, k.grad, v.grad), want):
        assert _rel_err(a.transpose(1, 2), w) <= tol, name


# ---- int8 GEMM, quantize, dequantize: bit for bit ------------------------

def _normal_cuda(shape, seed, dtype=torch.bfloat16, scale=1.0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal(shape, np.float32) * scale)
            .to("cuda", dtype))


@pytest.mark.parametrize("m, n, k, out", [
    (256, 384, 512, torch.bfloat16),
    (333, 1000, 200, torch.bfloat16),      # ragged M, N; K % 16 != 0
    (333, 1000, 5632, torch.float32),
    (130, 32000, 256, torch.float32),      # the head's N
    (64, 96, 48, torch.float16),
])
def test_int8_kernel_matches_plain_bit_for_bit(cuda, m, n, k, out):
    xq, sx = i8._quant_rows(_normal_cuda((m, k), 1))
    wq, sw = i8._quant_rows(_normal_cuda((n, k), 2, scale=0.05))
    before = i8.launches
    got = i8.int8_matmul_kernel(xq, sx, wq, sw, out)
    want = i8.int8_matmul_plain(xq, sx, wq, sw, out)
    torch.cuda.synchronize()
    assert i8.launches == before + 1
    assert got.dtype == out and got.shape == (m, n)
    assert torch.equal(got, want)


# The wgmma GEMM's edges: 128 x 256 output tiles and 128-byte K tiles,
# decode's M of 1; K 40 takes the byte-wise path.
@pytest.mark.parametrize("m, n, k, out", [
    *[(m, n, k, out) for m in (1, 127, 129, 8192) for n in (129, 257)
      for k in (16, 48, 2064) for out in (torch.float32, torch.bfloat16)],
    (129, 257, 40, torch.bfloat16),
])
def test_int8_kernel_at_tile_edges(cuda, m, n, k, out):
    xq, sx = i8._quant_rows(_normal_cuda((m, k), 7))
    wq, sw = i8._quant_rows(_normal_cuda((n, k), 8, scale=0.05))
    got = i8.int8_matmul_kernel(xq, sx, wq, sw, out)
    want = i8.int8_matmul_plain(xq, sx, wq, sw, out)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_int8_pallas_route_launches_the_kernel_and_backward_runs(cuda):
    x = _normal_cuda((2, 100, 256), 3).requires_grad_()
    w = _normal_cuda((384, 256), 4, scale=0.05).requires_grad_()
    before = i8.launches
    y = i8.int8_matmul_pallas(x, w)
    assert i8.launches == before + 1
    y_xla = i8.int8_matmul(x, w)             # torch._int_mm + epilogue
    assert torch.equal(y, y_xla)
    y.float().sum().backward()
    assert x.grad.shape == x.shape and w.grad.shape == w.shape


def test_int8_kernel_refuses_what_it_does_not_take(cuda):
    xq = torch.zeros(32, i8.MAX_K + 1, dtype=torch.int8, device="cuda")
    one = torch.ones(32, 1, device="cuda")
    with pytest.raises(ValueError, match="overflow"):
        i8.int8_matmul_kernel(xq, one, xq, one, torch.bfloat16)
    with pytest.raises(ValueError, match="int8 operands"):
        i8.int8_matmul_kernel(xq.float(), one, xq, one, torch.bfloat16)


@pytest.mark.parametrize("r, c, dtype", [
    (4096, 4096, torch.bfloat16), (1000, 11008, torch.bfloat16),
    (333, 200, torch.float32), (77, 131, torch.bfloat16),
    (5, 32000, torch.float32),
])
def test_quant_kernel_matches_plain_bit_for_bit(cuda, r, c, dtype):
    x = _normal_cuda((r, c), 5, dtype, 0.02)
    before = quant.quant_launches
    values, scales = quant.quantize_int8(x, seed=11)
    want_v, want_s = quant.quantize_int8_plain(x, seed=11)
    torch.cuda.synchronize()
    assert quant.quant_launches == before + 1
    assert torch.equal(scales, want_s)
    assert torch.equal(values, want_v)


@pytest.mark.parametrize("r, c, dtype", [
    (2048, 2048, torch.float32), (300, 5632, torch.bfloat16),
    (33, 77, torch.float32), (16, 32000, torch.float16),
])
def test_dequant_kernel_matches_plain_bit_for_bit(cuda, r, c, dtype):
    values, scales = quant.quantize_int8(_normal_cuda((r, c), 6,
                                                      torch.float32), seed=2)
    before = quant.dequant_launches
    got = quant.dequantize_int8(values, scales, dtype)
    want = quant.dequantize_int8_plain(values, scales, dtype)
    torch.cuda.synchronize()
    assert quant.dequant_launches == before + 1
    assert got.dtype == dtype and torch.equal(got, want)
