"""The port's checkpointing (``checkpoint/checkpoint.py``) and its restart
drill (``launch/train.py``), the counterparts of the reference's
tests/test_runtime.py: a round trip of every leaf type (bf16 and fp8 as
bit patterns, 0-dim ints, nested lists and tuples) bitwise, on the
template's dtype; the manifest as the commit point; garbage collection;
the asynchronous save; and the restart drill through ``train.run`` on
reduced SmolLM-360M on the CPU (12 steps, a checkpoint every 4, a failure
injected at step 7, then ``--restart``): the final losses within the
reference test's rtol 1e-5, here bitwise, and the state restored at step 4
bitwise the state saved there.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.launch import train
from repro_torch.optim.optimizers import tree_leaves, tree_map
from repro_torch.runtime.fault_tolerance import WorkerFailure


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": [{"c": torch.randn(2, 3, generator=g).to(torch.bfloat16)},
                  {"c": torch.zeros(2, dtype=torch.bfloat16)}],
            "f8": torch.randn(5, generator=g).to(torch.float8_e4m3fn),
            "n": torch.tensor(3, dtype=torch.int32),
            "t": (torch.ones(1, dtype=torch.int64),)}


def _bits(t):
    return t.reshape(-1).view(torch.uint8) if t.element_size() == 1 \
        else t.reshape(-1).view(torch.int16 if t.element_size() == 2
                                else torch.int32 if t.element_size() == 4
                                else torch.int64)


@pytest.mark.parametrize("blocking", [True, False])
def test_checkpoint_roundtrip(tmp_path, blocking):
    tree = _tree()
    t = ckpt.save(str(tmp_path), 7, tree, blocking=blocking)
    if not blocking:
        t.join()
    template = tree_map(torch.zeros_like, tree)
    out, step = ckpt.restore(str(tmp_path), 7, template)
    assert step == 7 and isinstance(out["t"], tuple)
    for a, b in zip(tree_leaves(tree), tree_leaves(out), strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(_bits(a), _bits(b))
    man = json.loads((tmp_path / "step_7" / "MANIFEST.json").read_text())
    assert man["leaves"]["b__#0__c"] == {"shape": [2, 3],
                                        "dtype": "bfloat16"}
    stored = np.load(tmp_path / "step_7" / "arrays" / "b__#0__c.npy")
    assert stored.dtype == np.uint16                # bf16 as its bits


def test_restore_takes_the_template_dtype(tmp_path):
    ckpt.save(str(tmp_path), 1, {"w": torch.ones(3)})
    out, _ = ckpt.restore(str(tmp_path), 1,
                          {"w": torch.zeros(3, dtype=torch.float64)})
    assert out["w"].dtype == torch.float64
    with pytest.raises(KeyError, match="missing leaf"):
        ckpt.restore(str(tmp_path), 1, {"v": torch.zeros(3)})


def test_checkpoint_commit_point_is_manifest(tmp_path):
    """A save that dies before the manifest is invisible to latest_step."""
    ckpt.save(str(tmp_path), 1, {"a": torch.ones(4)})
    os.makedirs(tmp_path / "step_2" / "arrays", exist_ok=True)
    np.save(tmp_path / "step_2" / "arrays" / "a.npy", np.zeros(4))
    os.makedirs(tmp_path / "step_3.tmp" / "arrays", exist_ok=True)
    assert ckpt.latest_step(str(tmp_path)) == 1
    assert ckpt.latest_step(str(tmp_path / "none")) is None


def test_checkpoint_gc(tmp_path):
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, {"a": torch.ones(2)})
    ckpt.gc_old(str(tmp_path), keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 5
    assert not os.path.exists(tmp_path / "step_1")
    assert os.path.exists(tmp_path / "step_4")


def test_save_copies_before_returning(tmp_path):
    """The caller may update the tree in place as soon as save returns."""
    tree = {"w": torch.zeros(1000)}
    t = ckpt.save(str(tmp_path), 1, tree, blocking=False)
    tree["w"].add_(1.0)
    t.join()
    out, _ = ckpt.restore(str(tmp_path), 1, {"w": torch.ones(1000)})
    assert float(out["w"].abs().sum()) == 0.0


BASE = ["--arch", "smollm_360m", "--reduced", "--device", "cpu", "--steps",
        "12", "--batch", "2", "--seq", "32", "--ckpt-every", "4",
        "--log-every", "0"]


def test_failure_injection_and_restart_equivalence(tmp_path, monkeypatch):
    """Run A uninterrupted; run B dies at step 7, restarts from its last
    checkpoint (step 4) and finishes: the final losses match, and the
    state restored at step 4 is bitwise the state saved there (a copy of
    what the trainer hands ``checkpoint.save``)."""
    ref = train.run(train.parse_args(BASE + ["--ckpt-dir",
                                             str(tmp_path / "a")]))
    saved = {}
    save = ckpt.save

    def keep(path, step, tree, **kw):
        saved[step] = tree_map(lambda t: t.clone(), tree)
        return save(path, step, tree, **kw)

    monkeypatch.setattr(ckpt, "save", keep)
    argsB = BASE + ["--ckpt-dir", str(tmp_path / "b")]
    with pytest.raises(WorkerFailure):
        train.run(train.parse_args(argsB + ["--fail-at", "7"]))
    assert sorted(saved) == [4] and ckpt.latest_step(str(tmp_path / "b")) == 4
    restored, _ = ckpt.restore(str(tmp_path / "b"), 4, saved[4])
    for a, b in zip(tree_leaves(restored), tree_leaves(saved[4]),
                    strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    out = train.run(train.parse_args(argsB + ["--restart"]))
    assert out["start_step"] == 4 and len(out["losses"]) == 8
    assert ckpt.latest_step(str(tmp_path / "b")) == 12
    np.testing.assert_allclose(ref["losses"][-1], out["losses"][-1],
                               rtol=1e-5)
    assert ref["losses"][4:] == out["losses"]       # on the CPU: bitwise
    assert out["alive"] == ["host0"]


def test_train_cli_flags():
    args = train.parse_args(["--layers", "1", "--n-micro", "2"])
    assert args.device == "cuda" and args.arch == "smollm_360m"
    assert (args.layers, args.n_micro, args.ckpt_every) == (1, 2, 10)
    cfg = train.model_config(train.parse_args(["--reduced", "--layers", "1",
                                               "--arch",
                                               "deepseek_r1_671b"]))
    assert cfg.num_layers == 1
    with pytest.raises(ValueError, match="--layers"):
        train.run(train.parse_args(BASE + ["--layers", "-1"]))


def test_train_main_n_micro_and_reduced_deepseek(capsys):
    """The CLI path with microbatches on a MoE stack (aux losses in the
    loss) runs and logs."""
    out = train.run(train.parse_args(
        ["--arch", "deepseek_r1_671b", "--reduced", "--device", "cpu",
         "--steps", "3", "--batch", "4", "--seq", "16", "--n-micro", "2",
         "--log-every", "1"]))
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    assert "[train] step 2 nll=" in capsys.readouterr().out
