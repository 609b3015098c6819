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

from tpu_on_k8s_torch.models import decode
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
    (torch.bfloat16, 256, True, 333, 0, True),
    (torch.float32, 128, True, 333, 0, True),
    (torch.float32, 64, False, 130, 100, False),
    (torch.float32, 256, False, 200, 150, False),
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
    (torch.bfloat16, 257, "head dims up to 256"),
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
    (torch.bfloat16, 256, 16, 8, True, 333, 0, True),
    (torch.float32, 128, 32, 8, True, 333, 0, True),
    (torch.float32, 64, 16, 4, False, 130, 100, False),
    (torch.float32, 256, 16, 4, True, 200, 150, False),
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
# K/V tiles of 128 keys (forward; 64 at D 256) and 64 (dq).
@pytest.mark.parametrize("d, l, hkv, causal, valid, segmented", [
    *[(d, l, 2, True, 0, False) for d in (64, 128, 256)
      for l in (63, 65, 127, 128, 129, 255, 2047)],
    *[(d, 255, 1, True, 129, False) for d in (64, 128, 256)],
    *[(d, 255, 2, True, 0, True) for d in (64, 128, 256)],
    (128, 300, 4, False, 0, True), (256, 300, 4, False, 0, True),
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
# warpgroups (at D 256 64-key blocks, each warpgroup half of dK and dV's
# columns), 64-row query tiles, the q-heads of a GQA group (rep 1, 2, 4)
# summed in order in bf16.
@pytest.mark.parametrize("d, l, hkv, valid, segmented", [
    *[(d, l, hkv, 0, False) for d in (64, 128, 256)
      for l in (63, 64, 65, 127, 128, 129, 255, 2047) for hkv in (4, 2, 1)],
    *[(d, 255, hkv, 129, False) for d in (64, 128, 256) for hkv in (4, 1)],
    *[(d, 255, hkv, 0, True) for d in (64, 128, 256) for hkv in (4, 2)],
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


# ---- the faults: head dims, _int_mm shapes, division on the card ---------

@pytest.mark.parametrize("d", [16, 32, 80, 96])
@pytest.mark.parametrize("l", [129, 2047])
def test_padded_head_dims_match_plain(cuda, d, l):
    """Head dims the kernels are not built for run zero-padded to 64 or 128,
    with the true head dim's scale: forward and backward within the
    kernels' tolerances of the plain twins."""
    q, k, v = _qkv(1, 4, 2, l, d, torch.bfloat16)
    do = _normal_cuda((1, 4, l, d), 9)
    o, lse = fa.flash_with_lse_fwd(q, k, v, True)
    po, plse = fa.flash_attention_plain(q, k, v, True)
    got = fa.flash_bwd(q, k, v, o, lse, do, True)
    want = _plain_bwd(q, k, v, o, lse, do, True, 0, None)
    torch.cuda.synchronize()
    tol_o, tol_lse = TOL[torch.bfloat16]
    assert o.shape == q.shape
    assert (o.float() - po.float()).abs().max().item() <= tol_o
    assert (lse - plse).abs().max().item() <= tol_lse
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert _rel_err(a, b) <= BWD_REL_TOL[torch.bfloat16]


@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 16, 17])
def test_int_mm_route_takes_decode_shapes(cuda, m, out):
    """``torch._int_mm`` takes M > 16 and K, N multiples of 8 on the card;
    the xla route pads to that and stays bit-identical to the plain GEMM."""
    xq, sx = i8._quant_rows(_normal_cuda((m, 40), 10))
    wq, sw = i8._quant_rows(_normal_cuda((129, 40), 11, scale=0.05))
    got = i8._int_mm(xq, sx, wq, sw, out)
    assert got.shape == (m, 129)
    assert torch.equal(got, i8.int8_matmul_plain(xq, sx, wq, sw, out))


def test_row_scales_divide_on_the_card(cuda):
    """The row scales of ``_quant_rows`` and of the serving quantizer on the
    card equal the CPU's, which divide by 127 as the reference does."""
    rows = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (4096, 64)).astype(np.float32))
    for fn in (i8._quant_rows, decode._absmax_rows):
        q_cpu, s_cpu = fn(rows)
        q_gpu, s_gpu = fn(rows.cuda())
        assert torch.equal(s_gpu.cpu(), s_cpu)
        assert torch.equal(q_gpu.cpu(), q_cpu)


def _quant_edge(r, c, dtype, kind):
    x = _normal_cuda((r, c), 13, dtype, 0.02)
    if kind == "zeros":
        x[::2] = 0
    elif kind == "one":
        x.zero_()
        x[:, 5] = torch.arange(1, r + 1, device="cuda", dtype=dtype)
    elif kind == "subnormal":
        x = (x * (torch.finfo(dtype).smallest_normal / 0.08)).to(dtype)
        x[1::3, 7] = 1.0
    elif kind == "misaligned":
        flat = _normal_cuda((r * c + 8,), 14, dtype, 0.02)
        x = flat[1:1 + r * c].view(r, c)
        assert x.data_ptr() % 16
    return x


@pytest.mark.parametrize("r, c, dtype, kind", [
    (64, 4096, torch.bfloat16, "zeros"), (64, 4096, torch.bfloat16, "one"),
    (64, 4096, torch.float32, "subnormal"),
    (64, 4096, torch.bfloat16, "subnormal"),
    (100, 4096, torch.bfloat16, "misaligned"),
    (500, 1, torch.bfloat16, None), (333, 3, torch.float32, None),
    (333, 17, torch.bfloat16, None), (64, 32000, torch.float32, None),
])
def test_quant_kernel_at_its_edges(cuda, r, c, dtype, kind):
    x = _quant_edge(r, c, dtype, kind)
    values, scales = quant.quantize_int8(x, seed=3)
    want_v, want_s = quant.quantize_int8_plain(x, seed=3)
    assert torch.equal(scales, want_s)
    assert torch.equal(values, want_v)


@pytest.mark.parametrize("r, c, dtype", [
    (500, 1, torch.float32), (333, 3, torch.bfloat16),
    (333, 17, torch.float16), (2048, 32000, torch.bfloat16),
    (2048, 32000, torch.float16),
])
def test_dequant_kernel_at_its_edges(cuda, r, c, dtype):
    values, scales = quant.quantize_int8(_normal_cuda((r, c), 15,
                                                      torch.float32), seed=4)
    got = quant.dequantize_int8(values, scales, dtype)
    assert torch.equal(got, quant.dequantize_int8_plain(values, scales, dtype))


def test_kv_handoff_roundtrip_on_the_card(cuda):
    """The disaggregated path at ``tiny`` on the card: a prefill engine's
    ``PrefillJob`` launches the flash forward once a layer, and its sealed
    handoff, adopted by a dense and by a paged decode engine, decodes the
    tokens a monolithic engine decodes, with no prefill and no flash launch
    on the decode engines."""
    from tpu_on_k8s_torch.models.params import init_params
    from tpu_on_k8s_torch.models.serving import ContinuousBatchingEngine
    from tpu_on_k8s_torch.models.transformer import TransformerConfig

    cfg = TransformerConfig.tiny()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, 40).astype(np.int32)
    mono = ContinuousBatchingEngine(cfg, params, n_slots=2, device="cuda")
    r = mono.submit(prompt, 12)
    want = mono.run()[r]
    prefill = ContinuousBatchingEngine(cfg, params, n_slots=2, device="cuda")
    before = fa.launches
    job = prefill.start_prefill(prompt)
    while not job.advance():
        pass
    assert fa.launches - before == cfg.n_layers
    ho = job.handoff()
    assert ho.verify() and ho.cache["k"].device.type == "cpu"
    for kw in ({}, {"kv_pages": 8}):
        dec = ContinuousBatchingEngine(cfg, params, n_slots=2, device="cuda",
                                       **kw)
        before = fa.launches
        rid = dec.submit_kv(ho, 12)
        np.testing.assert_array_equal(dec.run()[rid], want)
        assert fa.launches == before
        assert dec.stats["prefill_positions"] == 0


def test_multislot_append_of_a_chunk_on_the_card(cuda):
    """The multislot append of a 5-token chunk a row on the card (a valid
    write at the last position beside dropped ones aimed at it, a sentinel
    row): bit for bit the CPU's, and two launches agree."""
    from tpu_on_k8s_torch.models.transformer import KVCache, _append_per_row

    rng = np.random.default_rng(5)
    b, l, length = 3, 5, 64
    cache = torch.from_numpy(rng.standard_normal(
        (b, length, 8, 128)).astype(np.float32)).to(torch.bfloat16)
    new = torch.from_numpy(rng.standard_normal(
        (b, l, 8, 128)).astype(np.float32)).to(torch.bfloat16)
    pos = torch.from_numpy(np.stack([
        np.full(l, length), length - 1 + np.arange(l),
        4 + np.arange(l)]).astype(np.int32))
    outs = []
    for dev in ("cpu", "cuda", "cuda"):
        kv = KVCache(cache.clone().to(dev), cache.clone().to(dev))
        _append_per_row(new.to(dev), new.to(dev), pos.to(dev), kv)
        outs.append((kv.k.cpu(), kv.v.cpu()))
    for k, v in outs[1:]:
        assert torch.equal(k, outs[0][0]) and torch.equal(v, outs[0][1])
    assert torch.equal(outs[0][0][1, length - 1], new[1, 0])


def test_speculative_engine_on_the_card(cuda):
    """Speculative rounds at ``tiny`` (bf16) on the card, with the target
    itself and its first layer as the draft: every request completes, and
    the flash forward launches once a layer for each fresh prefill of the
    target and each fresh seed of the draft (bf16 GEMMs of the verify's
    rows and the draft's round differently, so acceptance is not held)."""
    from tpu_on_k8s_torch.models.decode import truncated_draft
    from tpu_on_k8s_torch.models.params import init_params
    from tpu_on_k8s_torch.models.serving import ContinuousBatchingEngine
    from tpu_on_k8s_torch.models.transformer import TransformerConfig

    cfg = TransformerConfig.tiny()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, 40).astype(np.int32)
    for dcfg, dparams in ((cfg, params), truncated_draft(cfg, params, 1)):
        eng = ContinuousBatchingEngine(cfg, params, n_slots=2, device="cuda",
                                       draft_cfg=dcfg, draft_params=dparams,
                                       spec_k=3)
        draft = eng._draft
        before = fa.launches
        r = eng.submit(prompt, 12)
        out = eng.run()[r]
        assert out.shape == (12,) and 0 <= out.min() <= out.max() < 256
        assert fa.launches - before == (
            cfg.n_layers * eng.stats["fresh_prefills"]
            + dcfg.n_layers * draft.fresh_prefills) > 0
        assert eng.stats["spec_rounds"] > 0
