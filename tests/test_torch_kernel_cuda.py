"""The Hopper flash-attention kernels against their plain versions, on the
card: the forward (``flash_fwd``) and the two backward kernels
(``flash_bwd_dq``, ``flash_bwd_dkv``).

Every test here needs a CUDA card and nvcc, and skips without them. The
file imports neither JAX nor the JAX package, so that it also runs on a
machine with a card and no JAX::

    python -m pytest --noconftest -m cuda tests/test_torch_kernel_cuda.py
"""
import numpy as np
import pytest
import torch

from tpu_on_k8s_torch.ops import flash_attention as fa

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
