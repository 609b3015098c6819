"""The port's reshard soak (``tpu_on_k8s_torch.reshard_soak``) against the
reference's ``tools/reshard_soak.py`` on the CPU.

* ``run_all(6172)``: the live and restart arms on the cost model, priced by
  the port's planner over meta tensors on a ``fake`` world of 8 made and
  destroyed around each plan; the whole record (events, summaries, wins,
  ``events_crc`` ``23b9ae46``) and the ``--ledger-out`` dump equal the
  reference's byte for byte, and no world is left behind.
* ``--bench --device cpu``: a spawned world of 4 gloo ranks moves the
  state 2→4→2 through ``TrainLoop`` and ``ReshardNotice``: the steps,
  reshards and bytes moved equal the reference's ``run_bench`` (8 forced
  CPU devices).
"""
from __future__ import annotations

import json

import pytest
import torch
import torch.distributed as dist

from tpu_on_k8s_torch import reshard_soak

torch.set_num_threads(1)

SEED = reshard_soak.DEFAULT_SEED


@pytest.fixture(scope="module")
def ref_soak():
    from tools import reshard_soak as ref
    return ref


def test_run_all_and_ledger_equal_the_reference(ref_soak, tmp_path):
    port_path, ref_path = tmp_path / "port.json", tmp_path / "ref.json"
    port = reshard_soak.run_all(SEED, ledger_out=str(port_path))
    ref = ref_soak.run_all(SEED, ledger_out=str(ref_path))
    assert not dist.is_initialized()
    assert port.pop("ledger_out") == str(port_path)
    assert ref.pop("ledger_out") == str(ref_path)
    assert json.dumps(port, sort_keys=True) == json.dumps(ref, sort_keys=True)
    assert port_path.read_bytes() == ref_path.read_bytes()
    assert port["events_crc"] == "23b9ae46"
    assert (port["pause_win_s"], port["goodput_win"]) == (357.328755,
                                                          0.790586)
    assert port["events"][0] == (
        "live: step=210 reshard fsdp=2 -> data=2,model=2 leaves=147 "
        "moved=147 bytes=1660944384 pause=2.166094")


def test_main_repeats_and_leaves_no_world(tmp_path, capsys):
    out = tmp_path / "ledger.json"
    assert reshard_soak.main(["--repeat", "2", "--ledger-out",
                              str(out)]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["repeats"] == 2 and got["identical_logs"] is True
    assert got["ledger_records"] == 8 and out.exists()
    assert not dist.is_initialized()


def test_planner_uses_an_initialised_world_and_leaves_it():
    from test_torch_parallel import end_fake_world, start_fake_world

    start_fake_world()
    try:
        up, down = reshard_soak._plans()
        assert dist.is_initialized()
        assert (up.bytes_moved, down.bytes_moved) == (1660944384,
                                                      1660944384)
    finally:
        end_fake_world()


def test_bench_on_a_gloo_world_equals_the_reference(ref_soak):
    port = reshard_soak.run_bench(SEED, "cpu")
    ref = ref_soak.run_bench(SEED)
    for key in ("steps", "reshards", "bytes_moved"):
        assert port[key] == ref[key], key
    assert (port["steps"], port["reshards"], port["bytes_moved"]) == (
        6, 2, 1048576)
    assert port["devices"] == 4 and port["platform"] == "cpu"
    assert not dist.is_initialized()


def test_bench_on_cuda_needs_four_cards(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        reshard_soak.main(["--bench"])
    assert "RESHARD_SOAK_FAILED seed=6172" in capsys.readouterr().err
