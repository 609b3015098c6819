"""The CPU half of the port's ``longcontext_proof`` at reduced lengths, on
one spawned world of 8 gloo ranks, against the reference's
``tools/longcontext_proof.py`` on the 8-device CPU platform.

* The ring step (seq 2048 here, 32768 in the tool) and the Ulysses step
  (1024 here, 16384 in the tool) on an 8-way ``seq`` mesh: finite losses,
  and a memory figure per rank with what it measures.
* The parity at seq 1024 (4096 in the tool) on the reference's parameters
  and tokens, carried across: the port's ring loss within 1e-5 of the
  reference's ring loss, and within the reference's 5e-3 of the port's
  plain attention; the plain losses equal.
* The gates: on the CPU the flash wrappers run their plain twins, which
  hold each rank's ``[h, Lq, Lk]`` scores and their temporaries, so both
  steps' figures stand above a tenth of the naive score matrix and the
  reference's memory gate fails for both (``cpu_gates`` names them);
  ``cpu_part`` writes the records before it raises.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from tpu_on_k8s_torch import longcontext_proof as lc
from tpu_on_k8s_torch.models.params import from_jax_params

torch.set_num_threads(1)

RING_SEQ, ULYSSES_SEQ, PARITY_SEQ = 2048, 1024, 1024


def _reference_parity(seq: int):
    """The reference's parity section at ``seq``: (params, tokens, ring
    loss, plain loss), as ``tools/longcontext_proof.cpu_part`` runs it."""
    import jax
    import jax.numpy as jnp
    from tools import longcontext_proof as ref
    from tpu_on_k8s.models.transformer import Transformer
    from tpu_on_k8s.parallel.mesh import MeshConfig, create_mesh
    from tpu_on_k8s.parallel.ring import ring_context
    from tpu_on_k8s.train.trainer import cross_entropy_loss

    cfg_r, cfg_x = ref._tiny_cfg(seq, "ring"), ref._tiny_cfg(seq, "xla")
    tokens = jax.random.randint(jax.random.key(2), (1, seq + 1), 0,
                                cfg_r.vocab_size, jnp.int32)
    mesh = create_mesh(MeshConfig(data=1, fsdp=1, model=1, seq=8),
                       jax.devices()[:8])
    params = Transformer(cfg_x).init(jax.random.key(3),
                                     tokens[:, :-1])["params"]

    def loss_of(cfg, in_mesh):
        model = Transformer(cfg)

        def f(p, t):
            logits = model.apply({"params": p}, t[:, :-1])
            return cross_entropy_loss(logits, t[:, 1:])
        if in_mesh:
            with ring_context(in_mesh):
                return float(jax.jit(f)(params, tokens))
        return float(jax.jit(f)(params, tokens))

    return (params, np.array(tokens), loss_of(cfg_r, mesh),
            loss_of(cfg_x, None))


@pytest.fixture(scope="module")
def runs():
    params, tokens, ref_ring, ref_plain = _reference_parity(PARITY_SEQ)
    records = lc.cpu_records(
        ring_seq=RING_SEQ, ulysses_seq=ULYSSES_SEQ, parity_seq=PARITY_SEQ,
        parity_params=from_jax_params(params, device="cpu"),
        parity_tokens=torch.from_numpy(tokens))
    return records, ref_ring, ref_plain


def test_ring_and_ulysses_steps(runs):
    records, _, _ = runs
    for key, seq, heads in (("ring_32k_dryrun", RING_SEQ, 2),
                            ("ulysses_16k_dryrun", ULYSSES_SEQ, 8)):
        rec = records[key]
        assert rec["seq"] == seq and rec["devices"] == 8
        assert rec["loss_finite"] and np.isfinite(rec["loss"])
        assert rec["naive_score_matrix_bytes"] == heads * seq * seq * 4
        assert rec["per_device_temp_bytes"] > 0
        assert rec["memory_measure"] == lc.CPU_MEMORY_MEASURE


def test_parity_against_the_reference(runs):
    records, ref_ring, ref_plain = runs
    parity = records["ring_parity_4096"]
    assert parity["seq"] == PARITY_SEQ
    assert abs(parity["ring_loss"] - ref_ring) < 1e-5
    assert parity["xla_loss"] == pytest.approx(ref_plain, abs=1e-6)
    assert parity["abs_diff"] < 5e-3
    assert parity["abs_diff"] == abs(parity["ring_loss"]
                                     - parity["xla_loss"])


def test_the_memory_gates_as_the_plain_twins_leave_them(runs):
    records, _, _ = runs
    failed = lc.cpu_gates(records)
    assert [f.split(" temp ")[0] for f in failed] == [
        "ring_32k_dryrun", "ulysses_16k_dryrun"]
    planted = json.loads(json.dumps(records))
    for key in ("ring_32k_dryrun", "ulysses_16k_dryrun"):
        planted[key]["per_device_temp_bytes"] = \
            planted[key]["naive_score_matrix_bytes"] // 20
    assert lc.cpu_gates(planted) == []
    planted["ring_parity_4096"]["abs_diff"] = 1e-2
    assert lc.cpu_gates(planted)[0].startswith("ring/xla diverge")


def test_cpu_part_writes_the_records_before_its_gates(runs, tmp_path,
                                                      monkeypatch):
    records, _, _ = runs
    monkeypatch.setattr(lc, "cpu_records", lambda **_: records)
    out = tmp_path / "lc.json"
    with pytest.raises(AssertionError, match="suspiciously close"):
        lc.cpu_part(out)
    assert json.loads(out.read_text()) == records


def test_the_card_half_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        lc.main([])
