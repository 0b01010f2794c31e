"""The training loop's parts on the CPU: the token stream against the
reference's, the checkpoint store, the straggler monitor, restart
continuity of the ``Trainer`` and the training launcher."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.data import tokens as ref_tokens
from repro.train.trainer import StragglerMonitor as RefStragglerMonitor
from repro_torch import configs
from repro_torch.checkpoint import CheckpointStore
from repro_torch.data import tokens
from repro_torch.models import model
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.trainer import StragglerMonitor, Trainer, TrainerConfig

ROOT = Path(__file__).resolve().parents[1]
ARCH = "tinyllama-1.1b"


@pytest.mark.parametrize("seed,index", [(0, 0), (0, 7), (3, 1), (11, 250)])
def test_token_batches_equal_reference(seed, index):
    kw = dict(vocab_size=384, seq_len=48, global_batch=3, seed=seed)
    got = tokens.make_batch(tokens.TokenStreamConfig(**kw), index)
    want = ref_tokens.make_batch(ref_tokens.TokenStreamConfig(**kw), index)
    assert got.keys() == want.keys()
    assert got["tokens"].dtype == want["tokens"].dtype == np.int32
    assert got["tokens"].tobytes() == want["tokens"].tobytes()
    stream = tokens.TokenStream(tokens.TokenStreamConfig(**kw), start_index=index)
    assert next(stream)["tokens"].tobytes() == got["tokens"].tobytes()
    assert stream.index == index + 1


def _state(dtype=torch.bfloat16, seed=0):
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH), dtype="bfloat16") \
        if dtype == torch.bfloat16 else configs.get_smoke_config(ARCH)
    net = model.init_params(seed, cfg, device="cpu")
    return model.init_train_state(net, AdamWConfig())


def _leaves(state):
    out = {f"params/{k}": v for k, v in state["params"].state_dict().items()}
    out.update({f"opt/mu/{k}": v for k, v in state["opt"].mu.items()})
    out.update({f"opt/nu/{k}": v for k, v in state["opt"].nu.items()})
    out["opt/step"], out["step"] = state["opt"].step, state["step"]
    return out


@pytest.mark.parametrize("blocking", [True, False])
def test_checkpoint_round_trip_is_bitwise(tmp_path, blocking):
    """A bf16 model, float32 moments and int32 steps come back bit for bit,
    on the template's devices and dtypes; the module is loaded in place."""
    state = _state()
    gen = torch.Generator().manual_seed(1)
    state["opt"] = state["opt"]._replace(
        mu={k: torch.randn(v.shape, generator=gen) for k, v in state["opt"].mu.items()},
        step=torch.tensor(5, dtype=torch.int32))
    state["step"] = torch.tensor(5, dtype=torch.int32)
    store = CheckpointStore(str(tmp_path), keep=2)
    store.save(5, state, blocking=blocking)
    saved = {k: v.clone() for k, v in _leaves(state).items()}
    with torch.no_grad():  # the train loop overwrites its tensors next
        for p in state["params"].parameters():
            p.add_(1.0)
    store.wait()
    assert store.latest_step() == 5
    manifest = json.loads((tmp_path / "step_00000005" / "manifest.json").read_text())
    assert {e["dtype"] for e in manifest["leaves"]} == {"bfloat16", "float32", "int32"}

    template = _state(seed=1)
    restored, step = store.restore(template)
    assert step == 5 and restored["params"] is template["params"]
    got = _leaves(restored)
    assert got.keys() == saved.keys()
    for k, v in saved.items():
        assert got[k].dtype == v.dtype and got[k].device == v.device, k
        assert torch.equal(got[k].view(torch.int16) if v.dtype == torch.bfloat16 else got[k],
                           v.view(torch.int16) if v.dtype == torch.bfloat16 else v), k


def test_uncommitted_step_is_ignored(tmp_path):
    store = CheckpointStore(str(tmp_path))
    state = _state(torch.float32)
    store.save(2, state)
    store.save(4, state)
    os.remove(tmp_path / "step_00000004" / "_COMPLETE")  # a crash before the commit marker
    assert store.latest_step() == 2
    _, step = store.restore(_state(torch.float32))
    assert step == 2
    (tmp_path / "latest").unlink()
    assert store.latest_step() is None


def test_async_save_failure_reaches_the_caller(tmp_path):
    store = CheckpointStore(str(tmp_path))
    (tmp_path / "latest.tmp").mkdir()  # the commit cannot write its pointer
    store.save(1, {"w": torch.zeros(2)}, blocking=False)
    with pytest.raises(IsADirectoryError):
        store.wait()
    store.wait()  # raised once


def test_keep_retains_the_newest(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=2)
    state = {"w": torch.arange(4.0), "opt": adamw_init({"w": torch.zeros(3)}, AdamWConfig())}
    for step in (1, 2, 3, 4):
        store.save(step, state, blocking=False)
    store.wait()
    assert sorted(p.name for p in tmp_path.glob("step_*")) == ["step_00000003", "step_00000004"]
    assert (tmp_path / "latest").read_text() == "step_00000004"
    restored, step = store.restore(state)
    assert step == 4 and torch.equal(restored["w"], state["w"])
    with pytest.raises(ValueError, match="shape mismatch"):
        store.restore({"w": torch.zeros(5), "opt": state["opt"]})


def test_straggler_monitor_matches_reference():
    times = [1.0, 1.1, 0.9, 3.0, 1.0, 2.6, 2.4, 0.2, 5.0, 1.05, 2.7]
    ours, theirs = StragglerMonitor(2.5), RefStragglerMonitor(2.5)
    flags = [ours.observe(t) for t in times]
    assert flags == [theirs.observe(t) for t in times]
    assert ours.events == theirs.events == sum(flags) > 0
    assert ours.ema == theirs.ema and ours.history == times


def test_trainer_restart_continues_the_run(tmp_path):
    """6 steps straight give the losses and weights of 3 steps, a
    checkpoint, a new trainer that restores it, and 3 more: the data resumes
    from the step index and the optimizer from its saved state."""
    cfg = configs.get_smoke_config(ARCH)
    kw = dict(seq_len=32, global_batch=2, device="cpu")
    straight = Trainer(cfg, TrainerConfig(total_steps=6, checkpoint_every=3, warmup_steps=2,
                                          checkpoint_dir=str(tmp_path / "a")), **kw).run()
    tcfg = TrainerConfig(total_steps=6, checkpoint_every=3, warmup_steps=2,
                         checkpoint_dir=str(tmp_path / "b"))
    first = Trainer(cfg, tcfg, **kw).run(steps=3)
    second = Trainer(cfg, tcfg, **kw).run()
    assert first["final_step"] == 3 and second["final_step"] == 6
    assert first["losses"] + second["losses"] == straight["losses"]
    assert len(straight["losses"]) == 6 and np.isfinite(straight["losses"]).all()
    a, b = straight["state"], second["state"]
    assert int(a["step"]) == int(b["step"]) == 6
    for (name, p), q in zip(a["params"].named_parameters(), b["params"].parameters()):
        assert torch.equal(p, q), name


@pytest.mark.parametrize("arch", [ARCH, "hymba-1.5b"])
def test_launcher_runs_on_the_cpu(tmp_path, arch):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch, "--smoke",
         "--device", "cpu", "--steps", "4", "--batch", "2", "--seq", "32",
         "--checkpoint-dir", str(tmp_path), "--checkpoint-every", "2"],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout)
    assert summary["arch"] == arch and summary["final_step"] == 4
    assert np.isfinite([summary["first_loss"], summary["final_loss"]]).all()
    assert (tmp_path / arch / "latest").read_text() == "step_00000004"
