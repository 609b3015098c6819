"""The Hopper flash-attention kernel against its plain version, on the card.

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
