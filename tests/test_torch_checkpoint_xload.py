"""The port's ``Trainer`` resumes a checkpoint that the reference's
``Trainer`` wrote (hymba's smoke config, on the CPU): the reference keys its
leaves by pytree path, the port maps them onto its train state through
``convert``. Its next step matches the reference's straight run."""
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.train.trainer import Trainer as RefTrainer
from repro.train.trainer import TrainerConfig as RefTrainerConfig
from repro_torch import configs, convert
from repro_torch.train.trainer import Trainer, TrainerConfig

ARCH = "hymba-1.5b"
KW = dict(seq_len=32, global_batch=2)
# both trainers run to step 3, so their warmup-cosine schedules agree (the
# third step at lr 5e-4); the reference stops after 2 and checkpoints there
TOTAL = 3
SCHEDULE = dict(total_steps=TOTAL, checkpoint_every=100, warmup_steps=1, peak_lr=1e-3)


def test_trainer_resumes_reference_checkpoint(tmp_path):
    """The reference's trainer saves at step 2; the port's, on the same
    directory, restores that state bit for bit and runs step 3, which
    matches the reference's straight 3-step run."""
    directory = tmp_path / "ckpt"
    ref_cfg = ref_smoke_config(ARCH)
    saved = RefTrainer(ref_cfg, RefTrainerConfig(checkpoint_dir=str(directory), **SCHEDULE),
                       **KW).run(steps=2)["state"]
    straight = RefTrainer(ref_cfg, RefTrainerConfig(checkpoint_dir=str(tmp_path / "straight"),
                                                    **SCHEDULE), **KW).run()
    manifest = json.loads((directory / "step_00000002" / "manifest.json").read_text())
    assert any(e["key"].startswith("params/decoder/units/") for e in manifest["leaves"])

    cfg = configs.get_smoke_config(ARCH)
    trainer = Trainer(cfg, TrainerConfig(checkpoint_dir=str(directory), **SCHEDULE),
                      device="cpu", **KW)
    # the restored state is the reference's at step 2, bit for bit
    restored = trainer.init_or_restore()
    host = jax.tree.map(np.asarray, saved)
    assert int(restored["step"]) == int(restored["opt"].step) == 2
    for name, tree in (("params", host["params"]), ("mu", host["opt"].mu),
                       ("nu", host["opt"].nu)):
        want = convert.named_from_reference(tree, cfg, "cpu")
        got = (dict(restored["params"].named_parameters()) if name == "params"
               else getattr(restored["opt"], name))
        assert sorted(got) == sorted(want), name
        for k in want:
            assert torch.equal(got[k].detach(), want[k]), (name, k)

    out = trainer.run()
    assert out["final_step"] == TOTAL and len(out["losses"]) == 1
    state = out["state"]
    assert int(state["step"]) == int(state["opt"].step) == TOTAL
    # one step of the port from the reference's state at step 2: the loss
    # as in test_torch_train.py (1e-6), the weights in its train-step band
    # (every element within 2 lr of the peak 1e-3, all but isolated ones
    # within rtol 5e-3, atol 2e-5)
    assert out["losses"][0] == pytest.approx(straight["losses"][-1], rel=1e-6)
    got = jax.tree.leaves(convert.model_params_to_reference(state["params"], cfg))
    want = jax.tree.leaves(jax.tree.map(np.asarray, straight["state"]["params"]))
    assert len(got) == len(want)
    off = 0
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 2 * SCHEDULE["peak_lr"]
        off += int((np.abs(a - b) > 2e-5 + 5e-3 * np.abs(b)).sum())
    assert off <= 1e-4 * sum(a.size for a in got)


def test_cross_load_names_a_missing_leaf(tmp_path):
    """A reference checkpoint with one leaf taken out of its manifest: the
    port's trainer raises and names that leaf; nothing is filled in."""
    directory = tmp_path / "ckpt"
    cfg = ref_smoke_config(ARCH)
    RefTrainer(cfg, RefTrainerConfig(checkpoint_dir=str(directory), **SCHEDULE),
               **KW).run(steps=1)
    path = directory / "step_00000001" / "manifest.json"
    manifest = json.loads(path.read_text())
    key = "opt/.nu/decoder/units/b2/mamba/a_log"
    manifest["leaves"] = [e for e in manifest["leaves"] if e["key"] != key]
    path.write_text(json.dumps(manifest))
    trainer = Trainer(configs.get_smoke_config(ARCH),
                      TrainerConfig(checkpoint_dir=str(directory), **SCHEDULE),
                      device="cpu", **KW)
    with pytest.raises(KeyError, match=key):
        trainer.run()
