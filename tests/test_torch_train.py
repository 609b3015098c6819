"""The PyTorch port's training pieces against the JAX package, on the CPU.

A ``TransformerConfig.tiny()`` model is initialised by the JAX package and
carried across with ``from_jax_params``; tokens, gradients and records come
from a numpy seed. Held against the reference here: the training forward's
logits (xla and flash attention, native GQA on and off, packed segments,
fused gate+up, bf16 compute), ``features`` with the chunked loss, the loss
helpers, the optimizer (optax's chain over 5 steps, three moment dtypes),
the copied data loader, and the training CLI. The 5-step training
trajectories are in ``tests/test_torch_train_step.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_on_k8s.data import DataLoader as JDataLoader
from tpu_on_k8s.data import FixedRecordDataset as JDataset
from tpu_on_k8s.models.transformer import Transformer as JTransformer
from tpu_on_k8s.models.transformer import TransformerConfig as JConfig
from tpu_on_k8s.train import trainer as jtrainer
from tpu_on_k8s_torch import train_llama
from tpu_on_k8s_torch.data import DataLoader, FixedRecordDataset, write_records
from tpu_on_k8s_torch.models import params as pparams
from tpu_on_k8s_torch.models.transformer import TransformerConfig
from tpu_on_k8s_torch.train import optimizer as popt
from tpu_on_k8s_torch.train import trainer as ptrainer

# tiny shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores under the suite's timing-sensitive tests
torch.set_num_threads(1)

# fp32 end to end: the two packages differ only in summation order. Over
# the cases below the tiny model's logits (up to ~0.6) agree to 2.4e-7 and
# its final hidden states (up to ~3) to 1.2e-6.
FP32_ATOL = 5e-6
# bf16 compute from fp32 masters, 2 layers: the packages round to bf16 in
# different places; the gap measured is 2.8e-3 for both attention paths.
BF16_ATOL = 1e-2

_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
EOS = 3


def port_config(jcfg: JConfig) -> TransformerConfig:
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(JConfig)}
    fields["dtype"] = _DTYPES[jcfg.dtype]
    fields["param_dtype"] = _DTYPES[jcfg.param_dtype]
    return TransformerConfig(**fields)


def packed_tokens(b=2, l=24, seed=0, vocab=256):
    """Random tokens with EOS separators: a few documents per row."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(4, vocab, (b, l)).astype(np.int32)
    for row in range(b):
        tokens[row, rng.choice(np.arange(2, l - 2), 3, replace=False)] = EOS
    return tokens


def setup(dtype=jnp.float32, **changes):
    jcfg = dataclasses.replace(JConfig.tiny(), dtype=dtype, **changes)
    tokens = packed_tokens()
    jparams = JTransformer(jcfg).init(jax.random.key(1),
                                      jnp.asarray(tokens))["params"]
    tree = jax.tree.map(np.asarray, jparams)
    model = pparams.load_model(
        port_config(jcfg), pparams.from_jax_params(tree, torch.float32,
                                                   "cpu"), "cpu")
    return jcfg, jparams, model, tokens


def _positions_segments(tokens, segmented):
    if not segmented:
        return None, None
    pos, seg = jtrainer.packed_positions_and_segments(jnp.asarray(tokens),
                                                      EOS)
    return np.array(pos), np.array(seg)


@pytest.mark.parametrize("attn, native_gqa, segmented, fused", [
    ("xla", False, False, False), ("flash", False, False, False),
    ("flash", True, False, False), ("xla", False, True, False),
    ("flash", False, True, False), ("flash", True, True, False),
    ("xla", False, False, True),
])
def test_training_logits_match_jax(attn, native_gqa, segmented, fused):
    jcfg, jparams, model, tokens = setup(attn_impl=attn,
                                         attn_native_gqa=native_gqa,
                                         mlp_fused_gateup=fused)
    pos, seg = _positions_segments(tokens, segmented)
    want = JTransformer(jcfg).apply(
        {"params": jparams}, jnp.asarray(tokens),
        None if pos is None else jnp.asarray(pos),
        None if seg is None else jnp.asarray(seg))
    got = model(torch.from_numpy(tokens),
                None if pos is None else torch.from_numpy(pos),
                segments=None if seg is None else torch.from_numpy(seg))
    assert got.dtype == torch.float32 and got.shape == (2, 24, 256)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=FP32_ATOL, rtol=0)


@pytest.mark.parametrize("attn", ["xla", "flash"])
def test_bf16_training_logits_near_jax(attn):
    """bf16 compute, fp32 master weights cast at every use in both."""
    jcfg, jparams, model, tokens = setup(dtype=jnp.bfloat16, attn_impl=attn)
    assert model.embed.dtype == torch.float32
    want = JTransformer(jcfg).apply({"params": jparams}, jnp.asarray(tokens))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=BF16_ATOL,
                               rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_features_and_chunked_loss_match_jax(masked):
    jcfg, jparams, model, tokens = setup(attn_impl="flash")
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    jfeats, jhead = JTransformer(jcfg).apply(
        {"params": jparams}, jnp.asarray(inputs), method="features")
    feats, head = model.features(torch.from_numpy(inputs))
    np.testing.assert_allclose(feats.detach().numpy(), np.asarray(jfeats),
                               atol=FP32_ATOL, rtol=0)
    np.testing.assert_array_equal(head.detach().numpy(), np.asarray(jhead))
    mask = (jtrainer.packed_loss_mask(jnp.asarray(tokens), EOS) if masked
            else None)
    want = jtrainer.chunked_cross_entropy(jfeats, jhead, jnp.asarray(targets),
                                          n_chunks=2, mask=mask)
    got = ptrainer.chunked_cross_entropy(
        feats, head, torch.from_numpy(targets), n_chunks=2,
        mask=None if mask is None else torch.from_numpy(np.array(mask)))
    dense = ptrainer.cross_entropy_loss(
        torch.matmul(feats.float(), head.float()), torch.from_numpy(targets),
        None if mask is None else torch.from_numpy(np.array(mask)))
    assert abs(got.item() - float(want)) <= FP32_ATOL
    assert abs(got.item() - dense.item()) <= FP32_ATOL


@pytest.mark.parametrize("step_kw", [{}, {"segment_eos": EOS},
                                     {"loss_chunks": 2}])
def test_eval_step_matches_jax(step_kw):
    """The forward-only objective: loss and perplexity, no state change."""
    jcfg, jparams, model, tokens = setup(attn_impl="flash")
    want = jtrainer.make_eval_step(JTransformer(jcfg), **step_kw)(
        jparams, jnp.asarray(tokens))
    before = {n: p.clone() for n, p in model.state_dict().items()}
    got = ptrainer.make_eval_step(model, **step_kw)(torch.from_numpy(tokens))
    assert abs(got["loss"].item() - float(want["loss"])) <= FP32_ATOL
    np.testing.assert_allclose(got["perplexity"].item(),
                               float(want["perplexity"]), rtol=1e-5)
    assert all(torch.equal(p, before[n])
               for n, p in model.state_dict().items())


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 9, 31)).astype(np.float32) * 3
    targets = rng.integers(0, 31, (2, 9)).astype(np.int32)
    mask = (rng.random((2, 9)) < 0.6).astype(np.float32)
    for m in (None, mask, np.zeros_like(mask)):
        want = jtrainer.cross_entropy_loss(
            jnp.asarray(logits), jnp.asarray(targets),
            None if m is None else jnp.asarray(m))
        got = ptrainer.cross_entropy_loss(
            torch.from_numpy(logits), torch.from_numpy(targets),
            None if m is None else torch.from_numpy(m))
        assert abs(got.item() - float(want)) <= 1e-6


def test_packed_positions_segments_and_mask_match_jax():
    tokens = packed_tokens(b=3, l=33, seed=4)
    tokens[0, 0] = EOS           # a window that opens with a separator
    tokens[1, -1] = EOS          # and one that closes with one
    jpos, jseg = jtrainer.packed_positions_and_segments(jnp.asarray(tokens),
                                                        EOS)
    pos, seg = ptrainer.packed_positions_and_segments(
        torch.from_numpy(tokens), EOS)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(seg.numpy(), np.asarray(jseg))
    np.testing.assert_array_equal(
        ptrainer.packed_loss_mask(torch.from_numpy(tokens), EOS).numpy(),
        np.asarray(jtrainer.packed_loss_mask(jnp.asarray(tokens), EOS)))


def test_schedule_matches_optax():
    want = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 10, 50)
    got = popt.warmup_cosine_decay_schedule(0.0, 3e-4, 10, 50)
    assert got(0) == 0.0
    for count in range(0, 60):
        np.testing.assert_allclose(got(count), float(want(count)),
                                   rtol=1e-6, atol=1e-12)


# Parameters of three shapes and five steps of gradients, scaled so that
# some steps clip (global norm above 1) and others do not.
_SHAPES = {"a": (6, 5), "b": (7,), "c": (3, 4, 2)}
_SCALES = (3.0, 0.05, 1.5, 0.1, 0.7)


# Parameters are O(1) and updates at most ~lr = 3e-4: fp32 moments agree to
# the last bits of p + update. A bf16 moment stores the fp32 value rounded;
# where the packages' fp32 values differ in the last bit the rounding can
# flip, moving that step's update by 2^-8 of itself (~1e-6 at lr 3e-4).
_OPT_ATOL = {"fp32": 1e-6, "bf16_mu": 1e-5, "bf16_mu_nu": 1e-5}


@pytest.mark.parametrize("moments", ["fp32", "bf16_mu", "bf16_mu_nu"])
def test_optimizer_matches_optax(moments):
    mu_dtype = None if moments == "fp32" else jnp.bfloat16
    nu_dtype = jnp.bfloat16 if moments == "bf16_mu_nu" else None
    rng = np.random.default_rng(3)
    init = {n: rng.standard_normal(s).astype(np.float32)
            for n, s in _SHAPES.items()}
    grads = [{n: (rng.standard_normal(s) * scale).astype(np.float32)
              for n, s in _SHAPES.items()} for scale in _SCALES]
    jopt = jtrainer.default_optimizer(warmup_steps=2, decay_steps=5,
                                      mu_dtype=mu_dtype, nu_dtype=nu_dtype)
    jparams = {n: jnp.asarray(x) for n, x in init.items()}
    jstate = jopt.init(jparams)
    tparams = {n: torch.from_numpy(x.copy()) for n, x in init.items()}
    topt = popt.default_optimizer(
        list(tparams.values()), warmup_steps=2, decay_steps=5,
        mu_dtype=None if mu_dtype is None else torch.bfloat16,
        nu_dtype=None if nu_dtype is None else torch.bfloat16)
    clipped = []
    for step, g in enumerate(grads):
        jg = {n: jnp.asarray(x) for n, x in g.items()}
        updates, jstate = jopt.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for n, p in tparams.items():
            p.grad = torch.from_numpy(g[n])
        norm = topt.step()
        clipped.append(float(optax.global_norm(jg)) >= 1.0)
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(jg)),
                                   rtol=1e-6)
        for n in _SHAPES:
            np.testing.assert_allclose(tparams[n].numpy(),
                                       np.asarray(jparams[n]),
                                       atol=_OPT_ATOL[moments], rtol=0,
                                       err_msg=f"{n} step {step}")
    assert any(clipped) and not all(clipped)
    state = topt.state[tparams["a"]]
    assert state["mu"].dtype == (torch.float32 if mu_dtype is None
                                 else torch.bfloat16)
    assert state["nu"].dtype == (torch.float32 if nu_dtype is None
                                 else torch.bfloat16)


def test_first_step_runs_at_lr_zero():
    p = torch.ones(4)
    opt = popt.default_optimizer([p], warmup_steps=3)
    p.grad = torch.full((4,), 2.0)
    opt.step()
    assert torch.equal(p, torch.ones(4))
    opt.step()
    assert not torch.equal(p, torch.ones(4))


@pytest.mark.parametrize("shuffle", [True, False])
def test_data_loader_matches_jax_package(tmp_path, shuffle):
    records = np.random.default_rng(5).integers(
        0, 1000, (37, 9)).astype(np.int32)
    path = str(tmp_path / "records.bin")
    write_records(path, records)
    mine = DataLoader(FixedRecordDataset(path, (9,), np.int32), batch_size=4,
                      seed=11, shuffle=shuffle)
    ref = JDataLoader(JDataset(path, (9,), np.int32), batch_size=4, seed=11,
                      shuffle=shuffle)
    py = DataLoader(FixedRecordDataset(path, (9,), np.int32), batch_size=4,
                    seed=11, shuffle=shuffle, force_python=True)
    try:
        for _ in range(20):            # past an epoch (9 batches) twice
            want = next(ref)
            np.testing.assert_array_equal(next(mine), want)
            np.testing.assert_array_equal(next(py), want)
    finally:
        for loader in (mine, ref, py):
            loader.close()


def test_cli_trains_tiny_on_cpu(capsys):
    loss = train_llama.main(["--config", "tiny", "--device", "cpu",
                             "--steps", "3", "--batch", "2",
                             "--seq-len", "32"])
    out = capsys.readouterr().out
    assert np.isfinite(loss)
    assert out.count("[elastic-metrics] epoch=0 batch=") == 3
    assert f"loss={loss:.4f} tok_s=" in out


def test_cli_trains_from_a_packed_record_file(tmp_path, capsys):
    windows = packed_tokens(b=6, l=17, seed=6)
    path = str(tmp_path / "windows.bin")
    write_records(path, windows)
    loss = train_llama.main(["--config", "tiny", "--device", "cpu",
                             "--steps", "2", "--batch", "2", "--seq-len",
                             "16", "--data", path, "--segment-eos", str(EOS),
                             "--remat-policy", "full", "--grad-accum", "2",
                             "--bf16-moments"])
    assert np.isfinite(loss)
    assert capsys.readouterr().out.count("[elastic-metrics]") == 2


@pytest.mark.parametrize("argv, match", [
    (["--int8"], "--int8"), (["--eval-data", "x"], "--eval-data"),
    (["--checkpoint-dir", "x"], "--checkpoint-dir"),
    (["--attn", "ring"], "ring"), (["--attn", "ulysses"], "ulysses"),
])
def test_cli_unported_flags_raise(argv, match):
    with pytest.raises(NotImplementedError, match=match):
        train_llama.main(["--config", "tiny", "--device", "cpu", *argv])
