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
from torch.utils._python_dispatch import TorchDispatchMode

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


@pytest.mark.parametrize("attn", ["ring", "ulysses"])
def test_cli_sequence_attention_on_one_rank(attn):
    """``--attn ring`` and ``--attn ulysses`` train on a world of one rank,
    a ``seq`` axis of 1, where each is the plain attention (the
    reference's semantics): the loss is ``--attn xla``'s, bit for bit."""
    argv = ["--config", "tiny", "--device", "cpu", "--steps", "2",
            "--batch", "2", "--seq-len", "16"]
    assert train_llama.main(argv + ["--attn", attn]) == train_llama.main(
        argv + ["--attn", "xla"])


@pytest.mark.parametrize("eval_every, evals", [(0, [3]), (2, [2, 3]),
                                               (3, [3])])
def test_cli_eval_data_evaluates_every_n_and_at_the_end(
        tmp_path, capsys, eval_every, evals):
    """``--eval-data`` loads the held-out batches once; the evaluation runs
    every ``--eval-every`` steps and once at the end unless it has just
    run, each on the same batches: the loss the eval step gives on them."""
    path = str(tmp_path / "eval.bin")
    write_records(path, packed_tokens(b=4, l=17, seed=9))
    train_llama.main(["--config", "tiny", "--device", "cpu", "--steps", "3",
                      "--batch", "2", "--seq-len", "16", "--eval-data", path,
                      "--eval-every", str(eval_every)])
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("[eval]")]
    assert [int(l.split("step=")[1].split()[0]) for l in lines] == evals
    assert all(np.isfinite(float(l.split("loss=")[1].split()[0]))
               for l in lines)


def test_cli_saves_after_an_evaluation(tmp_path):
    """An evaluation between steps leaves the model's parameters the
    optimizer's (the mesh's eval step reshards FSDP2's gathered root), so
    the final save holds every parameter with its moments."""
    from tpu_on_k8s_torch.train.checkpoint import CheckpointManager
    path, ckpt = str(tmp_path / "eval.bin"), str(tmp_path / "ckpt")
    write_records(path, packed_tokens(b=4, l=17, seed=9))
    train_llama.main(["--config", "tiny", "--device", "cpu", "--steps", "3",
                      "--batch", "2", "--seq-len", "16", "--eval-data", path,
                      "--eval-every", "2", "--checkpoint-dir", ckpt])
    state = ptrainer.train_state_template(TransformerConfig.tiny(), "cpu",
                                          warmup_steps=10, decay_steps=11)
    state, gen, step = CheckpointManager(ckpt).restore(state)
    assert (gen, step, state.optimizer.count) == (0, 3, 3)
    assert all(torch.isfinite(p).all() for p in state.model.parameters())


def test_cli_checkpoint_round_trip_through_generate_and_serve(tmp_path,
                                                              capsys):
    """``train_llama --checkpoint-dir`` saves the trained state; ``generate
    --checkpoint-dir`` and ``serve --checkpoint-dir`` restore its
    parameters, and their greedy tokens equal those of the same parameters
    held in memory."""
    from tpu_on_k8s_torch import generate as generate_cli
    from tpu_on_k8s_torch import serve as serve_cli
    from tpu_on_k8s_torch.models import decode
    from tpu_on_k8s_torch.models.serving import ContinuousBatchingEngine
    from tpu_on_k8s_torch.train.checkpoint import CheckpointManager

    ckpt = str(tmp_path / "ckpt")
    train_llama.main(["--config", "tiny", "--device", "cpu", "--steps", "3",
                      "--batch", "2", "--seq-len", "16",
                      "--checkpoint-dir", ckpt])
    cfg = TransformerConfig.tiny()
    state = ptrainer.train_state_template(cfg, "cpu", warmup_steps=10,
                                          decay_steps=11)
    state, gen, step = CheckpointManager(ckpt).restore(state)
    assert (gen, step, state.step, state.optimizer.count) == (0, 3, 3, 3)
    held = {n: p.detach().to(torch.float32 if n.endswith("scale")
                             else cfg.dtype)
            for n, p in state.model.named_parameters()}

    out = generate_cli.main(["--device", "cpu", "--checkpoint-dir", ckpt,
                             "--max-new-tokens", "6"])
    prompt = torch.randint(0, cfg.vocab_size, (1, 8), generator=torch.
                           Generator().manual_seed(0), dtype=torch.int32)
    want = decode.generate(cfg, held, prompt, 6, device="cpu")
    assert torch.equal(out, want)
    spec = generate_cli.main(["--device", "cpu", "--checkpoint-dir", ckpt,
                              "--draft-config", "tiny",
                              "--draft-checkpoint-dir", ckpt,
                              "--max-new-tokens", "6"])
    assert torch.equal(spec, want)

    served = serve_cli.main(["--device", "cpu", "--checkpoint-dir", ckpt,
                             "--n-requests", "3"])
    assert "restored generation=0 step=3" in capsys.readouterr().out
    rng = np.random.default_rng(0)
    eng = ContinuousBatchingEngine(cfg, held, n_slots=8, device="cpu")
    done, n = {}, 0
    while n < 3:        # the CLI's arrivals: the same seeded draws
        for _ in range(rng.poisson(1.0)):
            if n < 3:
                lp = int(rng.integers(4, 25))
                eng.submit(rng.integers(0, cfg.vocab_size,
                                        size=lp).astype(np.int32), 16)
                n += 1
        for rid in eng.step():
            done[rid] = eng.result(rid)
    done.update(eng.run())
    assert len(served) == 3
    assert {r: t.tolist() for r, t in served.items()} == {
        r: t.tolist() for r, t in done.items()}


class _CountProducts(TorchDispatchMode):
    """Counts the dense products (``aten.mm``) run under it."""

    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func is torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("int8", [False, True])
def test_mlp_remat_keeps_the_products_of_the_mlp_input(int8):
    """``remat_policy="mlp"`` saves what the reference's
    ``dots_with_no_batch_dims_saveable`` saves: the outputs of the gate and
    up products. Its backward runs as many dense products as the backward
    without remat (the SiLU and the product are recomputed, no GEMM), with
    ``mlp_int8`` too (whose product, on CPU tensors, is the plain twin's
    ``mm``): the recompute stops before w_down's int8 forward, whose output
    the backward never reads. The fp32 gradients equal those without
    remat, bit for bit."""
    cfg = dataclasses.replace(TransformerConfig.tiny(), mlp_int8=int8,
                              remat_policy="mlp")
    tokens = torch.from_numpy(packed_tokens())
    params = pparams.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                                 dtype=torch.float32)
    runs = []
    for remat in (False, True):
        model = pparams.load_model(dataclasses.replace(cfg, remat=remat),
                                   params, "cpu")
        loss = model(tokens).square().mean()
        counter = _CountProducts()
        with counter:
            grads = torch.autograd.grad(loss, list(model.parameters()))
        runs.append((counter.mm, grads))
    (mm_plain, g_plain), (mm_remat, g_remat) = runs
    assert mm_remat == mm_plain
    assert all(torch.equal(a, b) for a, b in zip(g_plain, g_remat))


class _CountOps(TorchDispatchMode):
    """Counts every operator run under it, by name."""

    def __init__(self):
        super().__init__()
        self.calls = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        self.calls[name] = self.calls.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


_INT8_OP = "tpu_on_k8s_torch.int8_matmul.default"
_FLASH_OP = "tpu_on_k8s_torch.flash_fwd.default"


def test_mlp_remat_does_not_replay_w_down_on_the_kernel_route():
    """The int8 kernel route (``int8_impl="pallas"``, the plain twin behind
    the operator on CPU tensors) under ``remat_policy="mlp"``: the
    backward re-runs the gate and up products (the kernel is no dot, so
    its outputs are recomputed, as a ``pallas_call``'s are in the
    reference) and not w_down's, whose output the backward never reads: 2
    int8 GEMMs a layer, as the reference's XLA runs them
    (``tests/test_torch_int8.py``: 3 in the forward, 5 with the remat)."""
    cfg = dataclasses.replace(TransformerConfig.tiny(), mlp_int8=True,
                              int8_impl="pallas", remat=True,
                              remat_policy="mlp")
    tokens = torch.from_numpy(packed_tokens())
    params = pparams.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                                 dtype=torch.float32)
    model = pparams.load_model(cfg, params, "cpu")
    forward = _CountOps()
    with forward:
        loss = model(tokens).square().mean()
    backward = _CountOps()
    with backward:
        torch.autograd.grad(loss, list(model.parameters()))
    assert forward.calls[_INT8_OP] == 3 * cfg.n_layers
    assert backward.calls[_INT8_OP] == 2 * cfg.n_layers


@pytest.mark.parametrize("policy", ["dots", "dots_kernels"])
def test_dots_remat_policies_match_no_remat_and_jax(policy):
    """``remat_policy="dots"`` and ``"dots_kernels"`` on tiny fp32 (flash
    attention, and the int8 MLP on the kernel route): the gradients equal
    the no-remat gradients bit for bit, and the JAX package's under the
    same policy within the fp32 tolerance. The recompute re-runs no dense
    product; "dots" re-runs the flash forward (a kernel's output is not a
    dot), "dots_kernels" keeps its o and lse, and the int8 kernel's
    outputs likewise."""
    runs = {}
    for int8 in (False, True):
        jcfg, jparams, _, tokens = setup(
            remat=True, remat_policy=policy, attn_impl="flash",
            mlp_int8=int8, int8_impl="pallas")
        tree = jax.tree.map(np.asarray, jparams)
        grads = {}
        for remat in (False, True):
            pcfg = dataclasses.replace(port_config(jcfg), remat=remat)
            model = pparams.load_model(pcfg, pparams.from_jax_params(
                tree, torch.float32, "cpu"), "cpu")
            fwd = _CountOps()
            with fwd:
                loss = model(torch.from_numpy(tokens)).square().mean()
            bwd = _CountOps()
            with bwd:
                g = torch.autograd.grad(loss, list(model.parameters()))
            grads[remat] = dict(zip([n for n, _ in model.named_parameters()],
                                    g))
            runs[(int8, remat)] = (fwd.calls, bwd.calls)
        assert all(torch.equal(grads[True][n], grads[False][n])
                   for n in grads[False])
        jgrads = jax.grad(lambda p: jnp.mean(jnp.square(JTransformer(
            jcfg).apply({"params": p}, jnp.asarray(tokens)))))(jparams)
        want = pparams.from_jax_params(jax.tree.map(np.asarray, jgrads),
                                       torch.float32, "cpu")
        for name, g in grads[True].items():
            np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                       rtol=0, atol=FP32_ATOL, err_msg=name)
    n = JConfig.tiny().n_layers
    for int8 in (False, True):
        (_, plain), (_, remat) = runs[(int8, False)], runs[(int8, True)]
        assert remat.get("aten.mm.default") == plain.get("aten.mm.default")
        assert remat.get(_FLASH_OP, 0) == (n if policy == "dots" else 0)
        assert remat.get(_INT8_OP, 0) == (
            2 * n if int8 and policy == "dots" else 0)
