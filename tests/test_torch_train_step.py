"""The PyTorch port's training step against the JAX package's, on the CPU.

Five steps of ``make_train_step`` in both packages from the same
``TransformerConfig.tiny()`` weights (initialised by JAX, carried across with
``from_jax_params``) on the same numpy-seeded token batches, with the
reference's ``default_optimizer`` at warmup 2: the loss and grad norm of
every step and the parameters after the last agree. The JAX flash path runs
the Pallas kernels in interpret mode; the port's runs the plain twins.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_on_k8s.models.transformer import Transformer as JTransformer
from tpu_on_k8s.models.transformer import TransformerConfig as JConfig
from tpu_on_k8s.train import trainer as jtrainer
from tpu_on_k8s_torch.models import params as pparams
from tpu_on_k8s_torch.models.transformer import TransformerConfig
from tpu_on_k8s_torch.train import default_optimizer, make_train_step

# tiny shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores under the suite's timing-sensitive tests
torch.set_num_threads(1)

STEPS = 5
EOS = 3
_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
# fp32: the packages differ only in summation order. Measured over the six
# variants: losses (~5.5) within 9.5e-7, grad norms (~1.5) within 2.3e-7
# relative, weights after five steps within 2.8e-7; the tolerances are about
# five times that.
FP32_TOL = dict(loss=5e-6, grad_norm=1e-6, params=1.5e-6)
# bf16 compute: the packages round to bf16 at different places. Measured:
# losses within 1.6e-4, grad norms within 2.2e-4 relative, and weights
# within 5.8e-4 (Adam's normalised update of a near-zero gradient can flip
# sign, up to 2 lr a step); the tolerances are about three times that.
BF16_TOL = dict(loss=5e-4, grad_norm=1e-3, params=2e-3)


def port_config(jcfg: JConfig) -> TransformerConfig:
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(JConfig)}
    fields["dtype"] = _DTYPES[jcfg.dtype]
    fields["param_dtype"] = _DTYPES[jcfg.param_dtype]
    return TransformerConfig(**fields)


def _batches(b=4, l=25, seed=0, vocab=256):
    """Two token batches [b, l] with EOS separators, used alternately."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        tokens = rng.integers(4, vocab, (b, l)).astype(np.int32)
        for row in range(b):
            tokens[row, rng.choice(np.arange(1, l - 1), 3,
                                   replace=False)] = EOS
        out.append(tokens)
    return out


def _jax_run(jcfg, jparams, batches, **step_kw):
    opt = jtrainer.default_optimizer(warmup_steps=2, decay_steps=STEPS)
    step = jtrainer.make_train_step(JTransformer(jcfg), opt, **step_kw)
    state = jtrainer.TrainState(step=jnp.zeros((), jnp.int32),
                                params=jparams, opt_state=opt.init(jparams))
    losses, norms = [], []
    for i in range(STEPS):
        state, m = step(state, jnp.asarray(batches[i % 2]))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, jax.tree.map(np.asarray, state.params)


def _port_run(pcfg, tree, batches, **step_kw):
    model = pparams.load_model(
        pcfg, pparams.from_jax_params(tree, torch.float32, "cpu"), "cpu")
    opt = default_optimizer(model.parameters(), warmup_steps=2,
                            decay_steps=STEPS)
    step = make_train_step(model, opt, **step_kw)
    losses, norms = [], []
    for i in range(STEPS):
        m = step(torch.from_numpy(batches[i % 2]))
        assert int(m["step"]) == i
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    return losses, norms, {n: p.detach() for n, p in model.state_dict()
                           .items()}


def _setup(dtype=jnp.float32, **changes):
    jcfg = dataclasses.replace(JConfig.tiny(), dtype=dtype, **changes)
    batches = _batches()
    jparams = JTransformer(jcfg).init(
        jax.random.key(1), jnp.asarray(batches[0][:, :-1]))["params"]
    return jcfg, jparams, jax.tree.map(np.asarray, jparams), batches


def _assert_trajectories_close(want, got, tol):
    (wl, wn, wtree), (gl, gn, gparams) = want, got
    np.testing.assert_allclose(gl, wl, atol=tol["loss"], rtol=0)
    np.testing.assert_allclose(gn, wn, rtol=tol["grad_norm"], atol=0)
    expected = pparams.from_jax_params(wtree, torch.float32, "cpu")
    assert set(expected) == set(gparams)
    for name, w in expected.items():
        np.testing.assert_allclose(gparams[name].float().numpy(), w.numpy(),
                                   atol=tol["params"], rtol=0, err_msg=name)


@pytest.mark.parametrize("attn, step_kw", [
    ("xla", {}),
    ("flash", {}),
    ("flash", {"grad_accum": 2}),
    ("xla", {"segment_eos": EOS}),
    ("flash", {"segment_eos": EOS, "grad_accum": 2}),
    ("flash", {"loss_chunks": 4}),
], ids=["xla", "flash", "flash-accum2", "xla-packed", "flash-packed-accum2",
        "flash-chunked"])
def test_fp32_trajectory_matches_jax(attn, step_kw):
    jcfg, jparams, tree, batches = _setup(attn_impl=attn)
    want = _jax_run(jcfg, jparams, batches, **step_kw)
    got = _port_run(port_config(jcfg), tree, batches, **step_kw)
    assert got[0][-2] < got[0][0]      # batch 0 again, after 2 updates
    _assert_trajectories_close(want, got, FP32_TOL)


def test_bf16_trajectory_near_jax():
    jcfg, jparams, tree, batches = _setup(dtype=jnp.bfloat16,
                                          attn_impl="flash")
    want = _jax_run(jcfg, jparams, batches)
    got = _port_run(port_config(jcfg), tree, batches)
    assert all(p.dtype == torch.float32 for p in got[2].values())
    _assert_trajectories_close(want, got, BF16_TOL)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_remat_changes_nothing(dtype):
    """Recomputing blocks (policy "full") or MLPs ("mlp") in the backward
    pass gives the trajectory without remat, bit for bit."""
    jcfg, _, tree, batches = _setup(dtype=dtype, attn_impl="flash")
    runs = [_port_run(port_config(dataclasses.replace(
                jcfg, remat=remat, remat_policy=policy)), tree, batches)
            for remat, policy in ((False, "full"), (True, "full"),
                                  (True, "mlp"))]
    for losses, norms, params in runs[1:]:
        assert losses == runs[0][0] and norms == runs[0][1]
        assert all(torch.equal(params[n], runs[0][2][n]) for n in params)
