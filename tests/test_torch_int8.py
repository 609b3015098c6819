"""The PyTorch port's int8 training recipe against the JAX package's, on the
CPU: ``int8_matmul`` / ``int8_matmul_pallas`` forward and backward, the
int8 paths of a tiny ``Transformer`` (``mlp_int8``, ``mlp_fused_gateup``,
``head_int8``, ``attn_int8``), a 5-step fp32 trajectory, and
``train_llama --int8``.

Inputs come from numpy seeds and go through both packages. The JAX Pallas
kernel runs in interpret mode where its tiles cover the shape and falls
back to its XLA path elsewhere (both give the same bits); the port's
wrappers run their plain twin on CPU tensors.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_on_k8s.models.transformer import Transformer as JTransformer
from tpu_on_k8s.models.transformer import TransformerConfig as JConfig
from tpu_on_k8s.ops import int8_matmul as jint8
from tpu_on_k8s.train import trainer as jtrainer
from tpu_on_k8s_torch import train_llama
from tpu_on_k8s_torch.models import params as pparams
from tpu_on_k8s_torch.models.transformer import (
    Int8Dense,
    Transformer,
    TransformerConfig,
)
from tpu_on_k8s_torch.ops import int8_matmul as pint8
from tpu_on_k8s_torch.train import default_optimizer, make_train_step

# tiny shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores under the suite's timing-sensitive tests
torch.set_num_threads(1)

_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def port_config(jcfg: JConfig) -> TransformerConfig:
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(JConfig)}
    fields["dtype"] = _DTYPES[jcfg.dtype]
    fields["param_dtype"] = _DTYPES[jcfg.param_dtype]
    return TransformerConfig(**fields)


def _bf16_pair(shape, seed, scale=1.0):
    """The same bf16 values as a JAX array and a torch tensor."""
    x = jnp.asarray(np.random.default_rng(seed).standard_normal(shape)
                    * scale, jnp.bfloat16)
    return x, torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


# (x shape, K, N, JAX pallas tiles): the first three are tiled by the JAX
# kernel (interpret mode); the last is ragged, where the JAX pallas path
# falls back to XLA and the port's kernel masks the edges itself.
_SHAPES = [((128, 256), 256, (64, 128, 128)),
           ((2, 64, 256), 384, (64, 128, 128)),
           ((96, 512), 256, (32, 128, 256)),
           ((3, 37, 200), 333, (512, 1024, 512))]


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("out", ["bf16", "fp32"])
@pytest.mark.parametrize("xshape, n, tiles", _SHAPES,
                         ids=["2d", "3d", "2d-bk256", "ragged-fallback"])
def test_forward_is_bit_identical_to_jax(impl, out, xshape, n, tiles):
    k = xshape[-1]
    jx, tx = _bf16_pair(xshape, 0)
    jw, tw = _bf16_pair((k, n), 1, 0.05)
    jout, tout = ((jnp.bfloat16, torch.bfloat16) if out == "bf16"
                  else (jnp.float32, torch.float32))
    if impl == "pallas":
        want = jint8.int8_matmul_pallas(jx, jw, jout, *tiles)
        got = pint8.int8_matmul_pallas(tx, tw.t(), tout, *tiles)
    else:
        want = jint8.int8_matmul(jx, jw, jout)
        got = pint8.int8_matmul(tx, tw.t(), tout)
    assert got.dtype == tout and tuple(got.shape) == xshape[:-1] + (n,)
    np.testing.assert_array_equal(_np(got), _np(want))


# The Hopper GEMM's edges (128 x 256 output tiles, 128-byte K tiles; K 40
# takes its byte-wise path): the CPU twin against the JAX pallas route, which
# falls back to XLA where its tiles do not cover the shape.
@pytest.mark.parametrize("k", [16, 48, 40])
@pytest.mark.parametrize("n", [129, 257])
@pytest.mark.parametrize("m", [1, 129])
def test_forward_is_bit_identical_to_jax_at_kernel_edges(m, n, k):
    jx, tx = _bf16_pair((m, k), 5)
    jw, tw = _bf16_pair((k, n), 6, 0.05)
    want = jint8.int8_matmul_pallas(jx, jw, jnp.bfloat16)
    got = pint8.int8_matmul_pallas(tx, tw.t(), torch.bfloat16)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (m, n)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_quantizers_are_bit_identical_to_jax():
    jx, tx = _bf16_pair((64, 256), 2)
    jq, js = jint8._quant_rows(jx)
    tq, ts = pint8._quant_rows(tx)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # the port's [N, K] weight: its row scales are the reference's column
    # scales of the [K, N] kernel
    jq, js = jint8._quant_cols(jx.T)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq).T)
    np.testing.assert_array_equal(ts.numpy()[:, 0], np.asarray(js)[0])


def test_plain_product_is_exact_int32():
    rng = np.random.default_rng(3)
    xq = rng.integers(-127, 128, (40, 5632)).astype(np.int8)
    wq = np.full((8, 5632), 127, np.int8)
    xq[0] = 127                              # the largest sum, 127² · K
    ones = torch.ones(40, 1), torch.ones(8, 1)
    got = pint8.int8_matmul_plain(torch.from_numpy(xq), ones[0],
                                  torch.from_numpy(wq), ones[1],
                                  torch.float64)
    want = xq.astype(np.int64) @ wq.astype(np.int64).T
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
    assert want[0, 0] == 127 * 127 * 5632 < 2 ** 31


# Backward: dx = g·w and dw = gᵀ·x from the unquantized operands, in the
# promoted type of g and each (fp32 for the fp32-out head), cast to x's and
# w's bf16. The packages sum in different orders, so a value's final bf16
# rounding may differ by one step: within 2⁻⁷ of the value (one bf16 ulp is
# at most 2⁻⁷ relative); and a value that nearly cancels carries the fp32
# sums' own order difference, bounded here by 2⁻²⁰ of the largest |value|.
# Measured: one value of 32,768 off by 4.8e-7, the rest within one ulp.
BWD_RTOL = 2.0 ** -7
BWD_ATOL_OF_MAX = 2.0 ** -20


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("out", ["bf16", "fp32"])
def test_backward_matches_jax_grad(impl, out):
    jx, tx = _bf16_pair((2, 48, 128), 4)
    jw, tw = _bf16_pair((128, 256), 5, 0.1)
    jout, tout = ((jnp.bfloat16, torch.bfloat16) if out == "bf16"
                  else (jnp.float32, torch.float32))
    g = np.random.default_rng(6).standard_normal((2, 48, 256))
    jg = jnp.asarray(g, jout)
    tg = torch.from_numpy(np.asarray(jg, np.float32)).to(tout)
    jfn = (jint8.int8_matmul if impl == "xla" else
           lambda x, w, o: jint8.int8_matmul_pallas(x, w, o, 32, 128, 128))
    _, vjp = jax.vjp(lambda x, w: jfn(x, w, jout), jx, jw)
    jdx, jdw = vjp(jg)
    tfn = pint8.int8_matmul if impl == "xla" else pint8.int8_matmul_pallas
    x = tx.clone().requires_grad_()
    w = tw.t().contiguous().requires_grad_()             # [N, K]
    tfn(x, w, tout).backward(tg)
    assert x.grad.dtype == torch.bfloat16 and w.grad.dtype == torch.bfloat16
    for got, want in ((_np(x.grad), _np(jdx)), (_np(w.grad).T, _np(jdw))):
        np.testing.assert_allclose(
            got, want, rtol=BWD_RTOL,
            atol=BWD_ATOL_OF_MAX * np.abs(want).max())


def test_backward_is_the_exact_bf16_product():
    """SwitchBack: the gradients are those of the plain bf16 product, not
    of the quantized one."""
    _, tx = _bf16_pair((4, 8, 32), 7)
    _, tw = _bf16_pair((16, 32), 8, 0.1)
    a = [tx.clone().requires_grad_(), tw.clone().requires_grad_()]
    b = [tx.clone().requires_grad_(), tw.clone().requires_grad_()]
    pint8.int8_matmul_pallas(*a).float().sum().backward()
    torch.nn.functional.linear(*b).float().sum().backward()
    assert torch.equal(a[0].grad, b[0].grad)
    assert torch.equal(a[1].grad, b[1].grad)


def test_unknown_impl_raises():
    cfg = dataclasses.replace(TransformerConfig.tiny(), mlp_int8=True,
                              int8_impl="cuda")
    model = pparams.load_model(cfg, pparams.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu", torch.float32), "cpu")
    with pytest.raises(ValueError, match="unknown int8_impl"):
        model(torch.zeros(1, 4, dtype=torch.int32))


# ---- the model -----------------------------------------------------------

_VARIANTS = {
    "mlp": dict(mlp_int8=True),
    "mlp-fused": dict(mlp_int8=True, mlp_fused_gateup=True),
    "head": dict(head_int8=True),
    "attn": dict(attn_int8=True),
    "all": dict(mlp_int8=True, mlp_fused_gateup=True, head_int8=True,
                attn_int8=True),
}
# fp32 compute: the packages' activations differ in the last bits (summation
# order); a value whose x / scale lies that close to a .5 boundary would
# round the other way and move its product by one quantization step. At
# this size none does: over the five variants and both impls, 2 layers,
# logits (std ~0.16) differed by at most 2.1e-7; the tolerance is ~5x that.
# bf16 compute: the packages round to bf16 in different places (3.2e-3-3.7e-3
# apart without int8, see test_torch_decode.py) and the int8 rounding
# follows its input: measured up to 8.2e-3 (all four flags); the tolerance
# is ~2x that.
LOGITS_ATOL = {jnp.float32: 1e-6, jnp.bfloat16: 1.5e-2}


def _jax_setup(tokens, dtype=jnp.float32, **changes):
    jcfg = dataclasses.replace(JConfig.tiny(), dtype=dtype, **changes)
    jparams = JTransformer(jcfg).init(jax.random.key(1),
                                      jnp.asarray(tokens))["params"]
    return jcfg, jparams, jax.tree.map(np.asarray, jparams)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_training_forward_logits_match_jax(variant, impl, dtype):
    tokens = np.random.default_rng(0).integers(0, 256, (2, 24)).astype(
        np.int32)
    jcfg, jparams, tree = _jax_setup(tokens, dtype, int8_impl=impl,
                                     **_VARIANTS[variant])
    want = JTransformer(jcfg).apply({"params": jparams}, jnp.asarray(tokens))
    model = pparams.load_model(port_config(jcfg), pparams.from_jax_params(
        tree, torch.float32, "cpu"), "cpu")
    if variant in ("attn", "all"):
        assert isinstance(model.blocks[0].attn.wq, Int8Dense)
    got = model(torch.from_numpy(tokens))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=LOGITS_ATOL[dtype], rtol=0)


STEPS = 5
# fp32, all four int8 flags: summation order, and the int8 rounding of
# values that it moves across a .5 boundary. Measured over 5 steps (both
# impls alike): losses (~5.45) within 4.3e-6, grad norms within 3.6e-6
# relative, weights within 1.9e-6; the tolerances are ~4-5x that.
TRAJ_TOL = dict(loss=2e-5, grad_norm=1.5e-5, params=1e-5)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_fp32_int8_trajectory_matches_jax(impl):
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 256, (4, 25)).astype(np.int32)
               for _ in range(2)]
    jcfg, jparams, tree = _jax_setup(batches[0][:, :-1], int8_impl=impl,
                                     **_VARIANTS["all"])
    opt = jtrainer.default_optimizer(warmup_steps=2, decay_steps=STEPS)
    jstep = jtrainer.make_train_step(JTransformer(jcfg), opt)
    state = jtrainer.TrainState(step=jnp.zeros((), jnp.int32),
                                params=jparams, opt_state=opt.init(jparams))
    model = pparams.load_model(port_config(jcfg), pparams.from_jax_params(
        tree, torch.float32, "cpu"), "cpu")
    step = make_train_step(model, default_optimizer(
        model.parameters(), warmup_steps=2, decay_steps=STEPS))
    for i in range(STEPS):
        state, m = jstep(state, jnp.asarray(batches[i % 2]))
        got = step(torch.from_numpy(batches[i % 2]))
        np.testing.assert_allclose(got["loss"].item(), float(m["loss"]),
                                   atol=TRAJ_TOL["loss"], rtol=0)
        np.testing.assert_allclose(got["grad_norm"].item(),
                                   float(m["grad_norm"]),
                                   rtol=TRAJ_TOL["grad_norm"], atol=0)
    expected = pparams.from_jax_params(jax.tree.map(np.asarray, state.params),
                                       torch.float32, "cpu")
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), expected[name].numpy(),
                                   atol=TRAJ_TOL["params"], rtol=0,
                                   err_msg=name)


def test_attn_int8_leaves_decode_projections_bf16():
    cfg = dataclasses.replace(TransformerConfig.tiny(), attn_int8=True,
                              mlp_int8=True, decode=True)
    with torch.device("meta"):
        model = Transformer(cfg)
    assert not isinstance(model.blocks[0].attn.wq, Int8Dense)
    assert isinstance(model.blocks[0].mlp.w_up, Int8Dense)


@pytest.mark.parametrize("changes, match", [
    (dict(use_bias=True, mlp_int8=True), "use_bias"),
    (dict(use_bias=True, attn_int8=True), "use_bias"),
])
def test_reference_value_errors(changes, match):
    cfg = dataclasses.replace(TransformerConfig.tiny(), **changes)
    with pytest.raises(ValueError, match=match):
        Transformer(cfg)


@pytest.mark.parametrize("changes", [dict(fused_qkv=True),
                                     dict(n_experts=4)])
def test_int8_with_unported_layouts_raises(changes):
    cfg = dataclasses.replace(TransformerConfig.tiny(), mlp_int8=True,
                              **changes)
    with pytest.raises(NotImplementedError):
        Transformer(cfg)


def test_train_llama_int8_on_cpu(capsys):
    loss = train_llama.main(["--config", "tiny", "--device", "cpu", "--int8",
                             "--steps", "3", "--batch", "2", "--seq-len",
                             "16"])
    assert np.isfinite(loss)
    out = capsys.readouterr().out
    assert out.count("[elastic-metrics]") == 3
