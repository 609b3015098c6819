"""The port's chaos soak (``tpu_on_k8s_torch.chaos_soak``) against the
reference's ``tools/chaos_soak.py`` on the CPU.

* The serve and train stages at the reference's ``tiny`` fp32 model, its
  parameters carried across (``models/params.from_jax_params``): the serve
  event lines and summary equal the reference's, and so does the train
  line but for ``losses_crc``. The 14 fault-free losses of the
  least-squares trajectory agree with the reference's within 1e-6
  relative but not bit for bit (an ulp apart at some steps: the two
  packages' fp32 reductions run in other orders), so the checksums of the
  two trajectories differ; each package's resumed run equals its own
  fault-free run bit for bit, which is the soak's assertion.
* The operator stage (REST backend, live controller threads) gives the
  reference's six event lines and summary on a ``TorchJob`` of one
  ``4x8`` slice.
* ``main`` replays twice and exits 0; without a card, ``main`` without
  ``--device cpu`` raises.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from tpu_on_k8s_torch import chaos_soak
from tpu_on_k8s_torch.models.params import from_jax_params
from tpu_on_k8s_torch.models.transformer import TransformerConfig
from tpu_on_k8s_torch.train.loop import TrainLoop

torch.set_num_threads(1)

SEED = chaos_soak.DEFAULT_SEED


@pytest.fixture(scope="module")
def ref_soak():
    from tools import chaos_soak as ref
    return ref


def _ref_tiny_params():
    """The reference serve stage's parameters, as it draws them."""
    import jax
    import jax.numpy as jnp
    from tpu_on_k8s.models.transformer import Transformer
    from tpu_on_k8s.models.transformer import TransformerConfig as RConfig

    cfg = dataclasses.replace(RConfig.tiny(), dtype=jnp.float32,
                              max_seq_len=64)
    probe = jax.random.randint(jax.random.key(0), (1, 8), 0, cfg.vocab_size,
                               jnp.int32)
    return Transformer(cfg).init(jax.random.key(1), probe)["params"]


def _port_cfg():
    return dataclasses.replace(TransformerConfig.tiny(), dtype=torch.float32,
                               max_seq_len=64)


def _split(events):
    train = [e for e in events if e.startswith("train:")]
    return [e for e in events if not e.startswith("train:")], train


def _crc_free(line: str) -> str:
    return line.rsplit(" losses_crc=", 1)[0]


def test_serve_and_train_stages_equal_the_reference(ref_soak):
    port = chaos_soak.run_all(SEED, skip_operator=True, device="cpu",
                              cfg=_port_cfg(),
                              params=from_jax_params(_ref_tiny_params(),
                                                     device="cpu"))
    ref = ref_soak.run_all(SEED, skip_operator=True)
    port_rest, port_train = _split(port["events"])
    ref_rest, ref_train = _split(ref["events"])
    assert port_rest == ref_rest
    assert port["serve"] == ref["serve"]
    assert [_crc_free(x) for x in port_train] == \
        [_crc_free(x) for x in ref_train]
    assert {k: v for k, v in port["train"].items() if k != "losses_crc"} \
        == {k: v for k, v in ref["train"].items() if k != "losses_crc"}
    assert port["serve"] == {"done": 6, "replayed": 2,
                             "retry_exhausted_storm": 2}


def _ref_losses(seed: int, steps: int) -> np.ndarray:
    from test_chaos import _toy_train
    from tpu_on_k8s.train.loop import TrainLoop as RefLoop

    step_fn, init_state, batches_from = _toy_train()
    run = RefLoop(step_fn, init_state(), batches_from(1, seed),
                  log_every=1).run(steps)
    return np.asarray([float(h["loss"]) for _, h in run.history])


def _port_losses(seed: int, steps: int) -> np.ndarray:
    step_fn, init_state = chaos_soak._least_squares(torch.device("cpu"))

    def batches_from(start):
        i = start
        while True:
            brng = np.random.default_rng((seed, i))
            yield tuple(torch.from_numpy(brng.normal(size=shape).astype(
                np.float32)) for shape in ((8, 4), (8, 2)))
            i += 1

    run = TrainLoop(step_fn, init_state(), batches_from(1),
                    log_every=1).run(steps)
    return np.asarray([float(h["loss"]) for _, h in run.history])


def test_train_trajectory_within_an_ulp_scale_of_the_reference():
    port, ref = _port_losses(SEED, 14), _ref_losses(SEED, 14)
    np.testing.assert_allclose(port, ref, rtol=1e-6, atol=0)


def test_operator_stage_equals_the_reference(ref_soak):
    events, summary = chaos_soak.run_operator_stage(SEED)
    ref_events, ref_summary = ref_soak.run_operator_stage(SEED)
    assert events == ref_events
    assert summary == ref_summary == {"watch_faults": 3, "slice_faults": 1,
                                      "replaced": 4}
    assert events == [
        "seq=1 watch_drop note=drop Pod stream",
        "seq=2 connection_reset note=refuse Pod reconnect",
        "seq=3 connection_reset note=refuse Pod reconnect",
        "operator: watch outage survived, job all-Running",
        "seq=1 slice_preempt note=preempt slice 0 of default/chaos-soak",
        "operator: slice recovered via failover, replaced=4"]


def test_main_replays_twice_and_exits_zero(capsys):
    import json

    assert chaos_soak.main(["--repeat", "2", "--skip-operator",
                            "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["repeats"] == 2 and out["identical_logs"] is True
    assert out["train"]["steps"] == 14 and out["serve"]["done"] == 6


def test_main_prints_the_seed_line_on_failure(monkeypatch, capsys):
    def broken(*a, **k):
        raise RuntimeError("planted")

    monkeypatch.setattr(chaos_soak, "run_train_stage", broken)
    with pytest.raises(RuntimeError, match="planted"):
        chaos_soak.main(["--seed", "7", "--repeat", "1", "--skip-operator",
                         "--device", "cpu"])
    assert "CHAOS_SOAK_FAILED seed=7: RuntimeError: planted" in \
        capsys.readouterr().err


def test_main_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        chaos_soak.main(["--repeat", "1", "--skip-operator"])
