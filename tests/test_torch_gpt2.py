"""The GPT-2 family in the PyTorch port against the JAX package, on the CPU.

Tiny GPT-2-family models (learned positions, LayerNorm, tanh-GELU, tied
embeddings; fp32; the shape of ``tests/test_decode.py``'s gpt2 case), with
and without biased projections, are initialised by the JAX package and
carried across with ``from_jax_params``; the biases are drawn from a numpy
seed (Flax initialises them to zero, which would leave the bias path
unchecked). Inputs come from numpy seeds. Held against the JAX package:
the forward logits, the prefill and decode-step logits, ``generate``'s
greedy tokens, the multislot step at the free-slot sentinel, the engine
(dense, paged, chunked, with a prefix, with free slots in its rounds),
speculative decoding with a GPT-2 draft, a five-step training trajectory
(the tied head through the plain and the chunked loss), a JAX training
state continued through ``from_jax_train_state``, the W8A16 tree of a
tied model and ``gpt2_small``'s parameter count. Also: the MLP remat
policy on the biased MLP, and ``train_gpt2``'s save and resume.

Tolerances: fp32 logits within ``FP32_ATOL``; tokens exact; training
within ``tests/test_torch_train_step.py``'s fp32 tolerances.
"""
import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tpu_on_k8s.models import decode as jdecode
from tpu_on_k8s.models.serving import ContinuousBatchingEngine as JEngine
from tpu_on_k8s.models.transformer import Transformer as JTransformer
from tpu_on_k8s.models.transformer import TransformerConfig as JConfig
from tpu_on_k8s.train import trainer as jtrainer
from tpu_on_k8s_torch import train_gpt2
from tpu_on_k8s_torch.models import convert, decode, params as pparams
from tpu_on_k8s_torch.models import transformer
from tpu_on_k8s_torch.models.serving import ContinuousBatchingEngine
from tpu_on_k8s_torch.models.transformer import (
    TransformerConfig,
    check_supported,
)
from tpu_on_k8s_torch.train import Trainer, default_optimizer, make_train_step

# tiny shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores under the suite's timing-sensitive tests
torch.set_num_threads(1)

# fp32 end to end: the packages differ only in summation order (LayerNorm's
# means, GELU's polynomial). Measured: logits (std ~0.16) within 2.4e-7.
FP32_ATOL = 1e-5
# tests/test_torch_train_step.py's fp32 tolerances (measured there on the
# Llama tiny). Measured here: losses within 9.6e-7, grad norms within
# 1.8e-7 relative, weights after five steps within 9.9e-7 (the biased
# model's; 6e-8 without biases).
FP32_TOL = dict(loss=5e-6, grad_norm=1e-6, params=1.5e-6)
STEPS = 5
PAGE = 16

_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
GPT2_TINY = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4,
                 n_kv_heads=4, d_ff=128, max_seq_len=64, remat=False,
                 dtype=jnp.float32, pos_emb="learned", norm="ln",
                 activation="gelu", tie_embeddings=True)


def port_config(jcfg: JConfig) -> TransformerConfig:
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(JConfig)}
    fields["dtype"] = _DTYPES[jcfg.dtype]
    fields["param_dtype"] = _DTYPES[jcfg.param_dtype]
    return TransformerConfig(**fields)


def jax_init(jcfg: JConfig, seed: int = 1):
    """(JAX params, the port's) of ``jcfg``; every bias drawn from a numpy
    seed."""
    tok = jnp.zeros((1, 8), jnp.int32)
    jparams = JTransformer(jcfg).init(jax.random.key(seed), tok)["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if path[-1].key != "bias":
            return leaf
        return jnp.asarray(rng.normal(0.0, 0.1, leaf.shape), leaf.dtype)

    jparams = jax.tree_util.tree_map_with_path(draw, jparams)
    return jparams, pparams.from_jax_params(
        jax.tree.map(np.asarray, jparams), device="cpu")


@dataclasses.dataclass
class Setup:
    jcfg: JConfig
    jparams: dict
    pcfg: TransformerConfig
    params: dict
    jax_engines: dict

    def engine(self, **kw) -> ContinuousBatchingEngine:
        kw.setdefault("n_slots", 3)
        return ContinuousBatchingEngine(self.pcfg, self.params, device="cpu",
                                        **kw)

    def jax_engine(self, **kw) -> JEngine:
        """One JAX engine per configuration for the whole module."""
        kw.setdefault("n_slots", 3)
        key = tuple(sorted(kw.items()))
        if key not in self.jax_engines:
            self.jax_engines[key] = JEngine(self.jcfg, self.jparams, **kw)
        return self.jax_engines[key]


@pytest.fixture(scope="module", params=[False, True], ids=["tied", "biased"])
def setup(request):
    jcfg = JConfig(**GPT2_TINY, use_bias=request.param)
    jparams, params = jax_init(jcfg)
    return Setup(jcfg, jparams, port_config(jcfg), params, {})


def prompts(seed, sizes, vocab=128):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in sizes]


def by_order(out: dict) -> dict:
    """{id: tokens} keyed by submission order (a module's JAX engine has
    served earlier tests, so its ids do not start at 0)."""
    return {j: out[rid] for j, rid in enumerate(sorted(out))}


def assert_same(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for j in want:
        np.testing.assert_array_equal(got[j], want[j], err_msg=f"request {j}")


@functools.lru_cache(maxsize=None)
def _jax_generate(jcfg, lp, n):
    return jax.jit(lambda params, prompt: jdecode.generate(jcfg, params,
                                                           prompt, n))


def want_generate(setup, prompt, n) -> np.ndarray:
    return np.asarray(_jax_generate(setup.jcfg, prompt.shape[-1], n)(
        setup.jparams, jnp.asarray(prompt, jnp.int32).reshape(1, -1)))[0]


# ---- the config and the parameter tree ------------------------------------

def test_gpt2_small_is_supported_and_counts_the_reference_params():
    """``check_supported`` passes on ``gpt2_small``, ``_NOT_PORTED`` names
    none of the GPT-2 flags, and the port's parameter count equals the
    reference's (``tests/test_bert_gpt2.py``: ~124M, tied)."""
    cfg = TransformerConfig.gpt2_small()
    check_supported(cfg)
    check_supported(dataclasses.replace(cfg, use_bias=True))
    assert not {"pos_emb", "norm", "activation", "tie_embeddings",
                "use_bias"} & {f for f, _, _ in transformer._NOT_PORTED}
    jcfg = JConfig.gpt2_small()
    shapes = jax.eval_shape(lambda: JTransformer(jcfg).init(
        jax.random.key(0), jnp.zeros((1, 16), jnp.int32)))["params"]
    want = sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(shapes))
    got = sum(s.numel() for s in pparams.param_shapes(cfg).values())
    assert got == want and 120e6 < got < 128e6
    assert "lm_head" not in pparams.param_shapes(cfg)
    assert pparams.param_shapes(cfg)["pos_embed"] == (1024, 768)


def test_tree_names_and_init(setup):
    """The GPT-2 tree: ``pos_embed``, norm and (biased) projection biases,
    the GELU MLP, no head; ``init_params`` draws matrices and tables and
    zeros the biases, with norm scales and biases in fp32."""
    names = set(setup.params)
    assert "pos_embed" in names and "lm_head" not in names
    assert "blocks.0.attn_norm.bias" in names
    assert "final_norm.bias" in names
    assert not any("w_gate" in n for n in names)
    assert ("blocks.1.mlp.w_up.bias" in names) == setup.pcfg.use_bias
    params = pparams.init_params(setup.pcfg, torch.Generator().manual_seed(0),
                                 "cpu")
    assert set(params) == names
    assert params["pos_embed"].dtype == torch.float32   # cfg.dtype fp32
    for name, t in params.items():
        if name.endswith(".bias"):
            assert not t.any(), name
        if "norm." in name:
            assert t.dtype == torch.float32
    bf16 = pparams.init_params(setup.pcfg, torch.Generator().manual_seed(0),
                               "cpu", dtype=torch.bfloat16)
    assert bf16["final_norm.bias"].dtype == torch.float32
    assert bf16["pos_embed"].dtype == torch.bfloat16


# ---- the forward and the serving path --------------------------------------

def test_forward_logits_match_jax(setup):
    tokens = prompts(0, (24, 24))
    tokens = np.stack(tokens)
    want = np.asarray(JTransformer(setup.jcfg).apply(
        {"params": setup.jparams}, jnp.asarray(tokens)))
    model = pparams.load_model(setup.pcfg, setup.params, "cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, atol=FP32_ATOL, rtol=0)


def test_prefill_and_decode_steps_match_jax(setup):
    """Decode mode at the full-length cache: a 10-token prefill, then three
    single-token steps, each call's logits against the reference's."""
    tokens = np.stack(prompts(1, (13, 13)))
    dm = jdecode.decode_model(setup.jcfg)
    jcache = jdecode.init_cache(dm, 2)
    model = decode.decode_model(setup.pcfg, setup.params, "cpu")
    cache = decode.init_cache(model, 2)
    assert cache[0].k.shape[1] == setup.pcfg.max_seq_len
    for start, end in ((0, 10), (10, 11), (11, 12), (12, 13)):
        pos = np.broadcast_to(np.arange(start, end), (2, end - start))
        want, upd = dm.apply({"params": setup.jparams, "cache": jcache},
                             jnp.asarray(tokens[:, start:end]),
                             jnp.asarray(pos, jnp.int32), mutable=["cache"])
        jcache = upd["cache"]
        with torch.inference_mode():
            got = model(torch.from_numpy(tokens[:, start:end]),
                        torch.from_numpy(pos.astype(np.int32)), cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=FP32_ATOL, rtol=0)


def test_generate_greedy_tokens_equal_jax(setup):
    prompt = np.stack(prompts(2, (7, 7)))
    got = decode.generate(setup.pcfg, setup.params, torch.from_numpy(prompt),
                          12, device="cpu")
    want = np.asarray(jdecode.generate(setup.jcfg, setup.jparams,
                                       jnp.asarray(prompt), 12))
    np.testing.assert_array_equal(got.numpy(), want)


def test_multislot_step_at_the_sentinel(setup):
    """A multislot step with a free slot at the sentinel position
    ``max_seq_len``, past the learned table: the reference's gather fills
    that row with NaN; the port clamps the gather, so the row is finite,
    and writes nothing. The live rows' logits and every cache byte match
    the reference's."""
    jcfg = dataclasses.replace(setup.jcfg, decode_multislot=True)
    pcfg = dataclasses.replace(setup.pcfg, decode_multislot=True)
    length = jcfg.max_seq_len
    dm = jdecode.decode_model(jcfg)
    rng = np.random.default_rng(3)
    jcache = jax.tree.map(
        lambda s: jnp.asarray(rng.standard_normal(s.shape), s.dtype),
        jdecode.cache_shapes(dm, 3))
    tok = np.asarray([[5], [9], [17]], np.int32)
    pos = np.asarray([[9], [length], [length - 1]], np.int32)
    want, upd = dm.apply({"params": setup.jparams, "cache": jcache},
                         jnp.asarray(tok), jnp.asarray(pos),
                         mutable=["cache"])
    want = np.asarray(want)
    model = decode.decode_model(pcfg, setup.params, "cpu")
    leaves = {name: torch.from_numpy(np.array(jcache["blocks"]["attn"][name]))
              for name in ("k", "v")}
    with torch.inference_mode():
        got = model(torch.from_numpy(tok), torch.from_numpy(pos),
                    decode.layer_caches(leaves)).numpy()
    assert np.isnan(want[1]).all() and np.isfinite(got).all()
    np.testing.assert_allclose(got[[0, 2]], want[[0, 2]], atol=FP32_ATOL,
                               rtol=0)
    for name, t in leaves.items():
        np.testing.assert_allclose(
            t.numpy(), np.asarray(upd["cache"]["blocks"]["attn"][name]),
            atol=FP32_ATOL, rtol=0)
        np.testing.assert_array_equal(
            t[:, 1].numpy(), np.asarray(jcache["blocks"]["attn"][name])[:, 1])


# ---- the engine --------------------------------------------------------------

def _traffic(eng, with_prefix=False):
    """Four requests on three slots, two arriving after three steps, so that
    free slots ride the rounds at the sentinel; with a registered prefix
    carried by two of them."""
    ps = prompts(5, (5, 11, 7, 9, 6))
    pid = eng.register_prefix(ps[4]) if with_prefix else None
    eng.submit(ps[0], 7)
    eng.submit(ps[1], 4, prefix_id=pid)
    for _ in range(3):
        eng.step()
    eng.submit(ps[2], 6, prefix_id=pid)
    eng.submit(ps[3], 9)
    return by_order(eng.run())


@pytest.mark.parametrize("mode, kw", [
    ("dense", {}),
    ("paged", {"kv_pages": 12, "page_tokens": PAGE}),
    ("chunked", {"prefill_chunk": 4}),
    ("prefix", {}),
    ("paged-prefix", {"kv_pages": 12, "page_tokens": PAGE}),
])
def test_engine_tokens_equal_jax(setup, mode, kw):
    """The port of ``tests/test_continuous_batching.py``'s GPT-2 engine
    test: the cache stays at the table's length (``max_len ==
    max_seq_len``) and every request's tokens equal the JAX engine's, in
    each mode; without a prefix they also equal the JAX ``generate``."""
    prefix = "prefix" in mode
    eng = setup.engine(**kw)
    assert eng.max_len == setup.pcfg.max_seq_len
    got = _traffic(eng, prefix)
    assert_same(got, _traffic(setup.jax_engine(**kw), prefix))
    if not prefix:
        for j, (p, n) in enumerate(zip(prompts(5, (5, 11, 7, 9)),
                                       (7, 4, 6, 9))):
            np.testing.assert_array_equal(got[j], want_generate(setup, p, n))
    if "paged" in mode:
        assert eng.null_page_is_zero()
        assert prefix or eng.pages_in_use == 0


def test_engine_max_len_is_pinned_to_the_table(setup):
    """A smaller ``max_len`` is pinned up to the table's length, a longer
    one refused, as the reference's engine does."""
    assert setup.engine(max_len=32).max_len == setup.pcfg.max_seq_len
    with pytest.raises(ValueError, match="needs rope"):
        setup.engine(max_len=2 * setup.pcfg.max_seq_len)


# ---- speculative decoding ----------------------------------------------------

SPEC_KEYS = ("spec_rounds", "spec_proposed", "spec_accepted")


def test_speculative_engine_with_a_gpt2_draft_equals_jax(setup):
    """The engine with the target's first layer as its GPT-2 draft:
    tokens and round counts equal the JAX engine's, tokens equal the JAX
    ``generate``'s."""
    dcfg, dparams = decode.truncated_draft(setup.pcfg, setup.params, 1)
    jd = jdecode.truncated_draft(setup.jcfg, setup.jparams, 1)
    eng = setup.engine(draft_cfg=dcfg, draft_params=dparams, spec_k=3)
    jeng = JEngine(setup.jcfg, setup.jparams, n_slots=3, draft_cfg=jd[0],
                   draft_params=jd[1], spec_k=3)
    got, want = _traffic(eng), _traffic(jeng)
    assert_same(got, want)
    assert eng.stats["spec_rounds"] > 0
    assert ({k: eng.stats[k] for k in SPEC_KEYS}
            == {k: jeng.stats[k] for k in SPEC_KEYS})
    for j, (p, n) in enumerate(zip(prompts(5, (5, 11, 7, 9)), (7, 4, 6, 9))):
        np.testing.assert_array_equal(got[j], want_generate(setup, p, n))


def test_speculative_generate_with_a_gpt2_draft_equals_jax(setup):
    dcfg, dparams = decode.truncated_draft(setup.pcfg, setup.params, 1)
    jd = jdecode.truncated_draft(setup.jcfg, setup.jparams, 1)
    prompt = prompts(6, (9,))[0][None]
    got, stats = decode.speculative_generate(
        setup.pcfg, setup.params, dcfg, dparams, torch.from_numpy(prompt),
        20, k=3, device="cpu")
    want, jstats = jdecode.speculative_generate(
        setup.jcfg, setup.jparams, *jd, jnp.asarray(prompt), 20, k=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats == jstats


def test_draft_shorter_than_the_engine_is_refused(setup):
    """A learned-position draft whose table is shorter than the engine's
    ``max_len`` cannot reach its positions: refused, as the reference
    refuses it."""
    jshort = dataclasses.replace(setup.jcfg, max_seq_len=32, n_layers=1)
    jdp, dparams = jax_init(jshort, seed=4)
    with pytest.raises(ValueError, match="learned positions"):
        setup.engine(draft_cfg=port_config(jshort), draft_params=dparams)
    with pytest.raises(ValueError, match="learned positions"):
        JEngine(setup.jcfg, setup.jparams, n_slots=2, draft_cfg=jshort,
                draft_params=jdp)


# ---- training -----------------------------------------------------------------

def _batches(b=4, l=25, seed=0, vocab=128):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (b, l)).astype(np.int32)
            for _ in range(2)]


def _jax_run(jcfg, jparams, batches, **step_kw):
    jparams = jax.tree.map(jnp.array, jparams)    # the step donates them
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


@pytest.mark.parametrize("attn, step_kw", [
    ("xla", {}), ("flash", {"loss_chunks": 4})], ids=["xla", "flash-chunked"])
def test_training_trajectory_matches_jax(setup, attn, step_kw):
    """Five steps from the same weights on the same batches: losses, grad
    norms and the weights after the last step within the fp32 tolerances.
    The tied head's gradient reaches ``embed`` through the plain loss and
    through ``chunked_cross_entropy`` (``features``' head); the JAX flash
    path runs the Pallas kernels in interpret mode, the port's the plain
    twins."""
    jcfg = dataclasses.replace(setup.jcfg, attn_impl=attn)
    batches = _batches()
    wl, wn, wtree = _jax_run(jcfg, setup.jparams, batches, **step_kw)
    model = pparams.load_model(
        port_config(jcfg), pparams.from_jax_params(
            jax.tree.map(np.asarray, setup.jparams), torch.float32, "cpu"),
        "cpu")
    step = make_train_step(model, default_optimizer(
        model.parameters(), warmup_steps=2, decay_steps=STEPS), **step_kw)
    gl, gn = [], []
    for i in range(STEPS):
        m = step(torch.from_numpy(batches[i % 2]))
        gl.append(m["loss"].item())
        gn.append(m["grad_norm"].item())
    np.testing.assert_allclose(gl, wl, atol=FP32_TOL["loss"], rtol=0)
    np.testing.assert_allclose(gn, wn, rtol=FP32_TOL["grad_norm"], atol=0)
    want = pparams.from_jax_params(wtree, torch.float32, "cpu")
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), w.numpy(),
                                   atol=FP32_TOL["params"], rtol=0,
                                   err_msg=name)


def test_from_jax_train_state_continues_a_gpt2_run(setup):
    """A JAX run stopped at step 3 continues in the port through
    ``from_jax_train_state`` (the Adam moments of ``pos_embed`` and of
    every bias carried too): steps 4-5 agree with the JAX run's."""
    batches = _batches(seed=1)
    opt = jtrainer.default_optimizer(warmup_steps=2, decay_steps=STEPS)
    step = jtrainer.make_train_step(JTransformer(setup.jcfg), opt)
    jparams = jax.tree.map(jnp.array, setup.jparams)  # the step donates them
    state = jtrainer.TrainState(step=jnp.zeros((), jnp.int32),
                                params=jparams, opt_state=opt.init(jparams))
    want = []
    for i in range(STEPS):
        if i == 3:
            at3 = jax.tree.map(np.array, state)
        state, m = step(state, jnp.asarray(batches[i % 2]))
        want.append((float(m["loss"]), float(m["grad_norm"])))
    pstate = pparams.from_jax_train_state(setup.pcfg, at3, "cpu",
                                          warmup_steps=2, decay_steps=STEPS)
    assert pstate.step == 3 == pstate.optimizer.count
    nu = pstate.optimizer.state[pstate.model.pos_embed]["nu"]
    assert nu.any()
    trainer = Trainer(pstate.model, pstate.optimizer)
    got = trainer.fit(pstate, iter(torch.from_numpy(batches[i % 2])
                                   for i in range(3, STEPS)), 2, log_every=1)
    for (_, g), (loss, norm) in zip(got.history, want[3:]):
        assert abs(g["loss"] - loss) <= FP32_TOL["loss"]
        assert abs(g["grad_norm"] - norm) <= FP32_TOL["grad_norm"] * norm
    final = pparams.from_jax_params(jax.tree.map(np.asarray, state.params),
                                    torch.float32, "cpu")
    for name, p in pstate.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), final[name].numpy(),
                                   rtol=0, atol=FP32_TOL["params"])


def test_mlp_remat_saves_the_up_product_of_the_biased_mlp():
    """``remat_policy="mlp"`` on the biased GELU MLP saves one product a
    layer, w_up's (its first operand is the MLP's input, not a bias: the
    bias is added after the product), recomputes the bias adds and the
    GELU, runs no dense product again in the backward, and gives the
    gradients of no remat bit for bit."""
    cfg = dataclasses.replace(port_config(JConfig(**GPT2_TINY,
                                                  use_bias=True)),
                              remat_policy="mlp")
    params = pparams.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                                 dtype=torch.float32)
    gen = torch.Generator().manual_seed(1)
    for name, t in params.items():
        if name.endswith(".bias"):
            t.normal_(0.0, 0.1, generator=gen)
    tokens = torch.from_numpy(np.stack(prompts(7, (16, 16))))
    saved, policy = [], transformer._mlp_remat_policy

    def recording(width):
        inner = policy(width)

        def decide(ctx, op, *args, **kwargs):
            out = inner(ctx, op, *args, **kwargs)
            if out == transformer.CheckpointPolicy.MUST_SAVE:
                saved.append((op, tuple(args[0].shape),
                              tuple(args[1].shape)))
            return out
        return decide

    counts, grads = [], []
    for remat in (False, True):
        with mock.patch.object(transformer, "_mlp_remat_policy", recording):
            model = pparams.load_model(dataclasses.replace(cfg, remat=remat),
                                       params, "cpu")
        loss = model(tokens).square().mean()
        counter = _CountMM()
        with counter:
            grads.append(torch.autograd.grad(loss,
                                             list(model.parameters())))
        counts.append(counter.mm)
    n = tokens.numel()
    # forward only: the recompute in the backward decides again, without
    # saving (non-reentrant checkpoints ask the policy in both passes)
    assert set(saved) == {(torch.ops.aten.mm.default, (n, cfg.d_model),
                           (cfg.d_model, cfg.d_ff))}
    assert len(saved) >= cfg.n_layers
    assert counts[0] == counts[1]
    assert all(torch.equal(a, b) for a, b in zip(*grads))


class _CountMM(TorchDispatchMode):
    """Counts the dense products (``aten.mm``) run under it."""

    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func is torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


# ---- W8A16 and the CLI ----------------------------------------------------------

def test_w8a16_tied_head_stays_full_precision():
    """The port of ``tests/test_decode.py::test_tied_embeddings_head_stays_fp``:
    the W8A16 tree of a bias-free tied GPT-2 model keeps ``embed`` (the
    head) and has no ``lm_head_q``; it equals the reference's tree carried
    across, and ``generate`` from it gives the reference's tokens."""
    jcfg = JConfig(**GPT2_TINY)
    jparams, params = jax_init(jcfg, seed=2)
    qp = decode.quantize_weights_for_serving(params)
    assert "lm_head_q" not in qp and "embed" in qp
    assert qp["embed"] is params["embed"]
    want_tree = pparams.from_jax_params(jax.tree.map(
        np.asarray, jdecode.quantize_weights_for_serving(jparams)),
        device="cpu")
    assert set(qp) == set(want_tree)
    for name, t in want_tree.items():
        torch.testing.assert_close(qp[name], t, atol=0, rtol=0, msg=name)
    scfg, sq = convert.quantize_serving_tree(port_config(jcfg), params,
                                             stochastic=True, seed=3)
    assert scfg.serve_int8_weights and "lm_head_q" not in sq
    assert sq["embed"] is params["embed"] and set(sq) == set(qp)
    prompt = np.stack(prompts(8, (8,)))
    qcfg = dataclasses.replace(port_config(jcfg), serve_int8_weights=True)
    got = decode.generate(qcfg, qp, torch.from_numpy(prompt), 6,
                          device="cpu")
    want = jdecode.generate(dataclasses.replace(jcfg,
                                                serve_int8_weights=True),
                            jdecode.quantize_weights_for_serving(jparams),
                            jnp.asarray(prompt), 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_train_gpt2_saves_and_resumes(tmp_path, capsys):
    """The port of ``tests/test_examples.py``'s ``train_gpt2`` test: a tiny
    run saves, a second run resumes from it (and saves its own generation),
    both with finite losses."""
    ckpt = str(tmp_path / "ckpt")
    args = ["--batch", "4", "--tiny", "--seq-len", "64", "--device", "cpu",
            "--checkpoint-dir", ckpt]
    loss1 = train_gpt2.main(["--steps", "2", *args])
    assert np.isfinite(loss1)
    assert "resumed" not in capsys.readouterr().out
    loss2 = train_gpt2.main(["--steps", "1", "--generation", "1", *args])
    assert np.isfinite(loss2)
    out = capsys.readouterr().out
    assert "resumed generation=0 step=2" in out
    assert "saved generation=1 step=3" in out
