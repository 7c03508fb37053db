"""The port's ``CheckpointStore`` against the reference's, on the CPU.

The anchors of ``tests/test_checkpoint.py`` on trees of tensors (round
trip, retention, async save, a torn checkpoint, a shape mismatch, a train
restart within the reference's 1e-5), and the on-disk format shared with
``repro.checkpoint.CheckpointStore``: each package restores what the
other saved.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointStore as JaxCheckpointStore
from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs import smoke_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models.api import build
from repro_torch.training import AdamW, make_train_step
from repro_torch.tree import leaves, tree_map

SRC = Path(__file__).resolve().parents[1] / "src"


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"layers": {"w": torch.randn(4, 8, generator=g),
                       "b": torch.zeros(8, dtype=torch.bfloat16)},
            "step_count": torch.tensor(7, dtype=torch.int32),
            "nested": [torch.randn(2, 2, generator=g),
                       torch.randn(3, generator=g).to(torch.bfloat16)]}


def _zeros(t):
    return tree_map(torch.zeros_like, t)


def test_save_restore_roundtrip(tmp_path):
    store = CheckpointStore(str(tmp_path))
    t = _tree()
    store.save(3, t, extra={"loss": 1.5})
    got, extra = store.restore(_zeros(t))
    assert extra == {"loss": 1.5}
    for a, b in zip(leaves(t), leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_latest_and_retention(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=2)
    t = _tree()
    for s in (1, 2, 3, 4):
        store.save(s, t)
    assert store.latest_step() == 4
    assert store.list_steps() == [3, 4]          # gc kept the newest 2


def test_async_save_then_restore(tmp_path):
    store = CheckpointStore(str(tmp_path))
    t = _tree(1)
    store.save_async(10, t)
    t["layers"]["w"].add_(1.0)       # the host copy was taken already
    store.wait()
    got, _ = store.restore(_zeros(t), step=10)
    assert torch.equal(got["layers"]["w"], _tree(1)["layers"]["w"])


def test_torn_checkpoint_invisible(tmp_path):
    """A .tmp staging dir is never listed as a valid checkpoint."""
    store = CheckpointStore(str(tmp_path))
    store.save(1, _tree())
    os.makedirs(os.path.join(str(tmp_path), "step_00000002.tmp"))
    assert store.list_steps() == [1]
    assert store.latest_step() == 1


def test_restore_rejects_shape_mismatch(tmp_path):
    store = CheckpointStore(str(tmp_path))
    t = _tree()
    store.save(1, t)
    bad = dict(t, layers={"w": torch.zeros(5, 8), "b": t["layers"]["b"]})
    with pytest.raises(ValueError, match="shape mismatch"):
        store.restore(bad)
    with pytest.raises(ValueError, match="leaf count mismatch"):
        store.restore({"w": torch.zeros(4, 8)})


def test_train_restart_continues(tmp_path):
    """Kill-and-restart: the restored run reproduces the uninterrupted
    run's loss within the reference test's 1e-5 (here bit for bit: the
    CPU's sums do not depend on the run)."""
    cfg = smoke_config("llama3.2-1b")
    model = build(cfg)
    opt = AdamW(lr=1e-3)
    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=8, global_batch=2)
    step = make_train_step(model.loss_fn, opt)
    params = model.init_params(torch.Generator().manual_seed(0))
    state = opt.init(params)
    store = CheckpointStore(str(tmp_path))
    for i in range(4):
        params, state, m = step(params, state, data.batch(i))
        if i == 1:
            store.save(i + 1, {"params": params, "opt": state},
                       extra={"data_step": i + 1})
    loss_direct = float(m["loss"])
    p9 = model.init_params(torch.Generator().manual_seed(9))
    restored, extra = store.restore({"params": p9, "opt": opt.init(p9)})
    p2, s2 = restored["params"], restored["opt"]
    assert int(s2.step) == 2 and s2.step.dtype == torch.int32
    for i in range(extra["data_step"], 4):
        p2, s2, m2 = step(p2, s2, data.batch(i))
    assert abs(float(m2["loss"]) - loss_direct) < 1e-5
    assert all(torch.equal(a, b) for a, b in zip(leaves(params),
                                                  leaves(p2)))


def _flat_numpy(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((4, 8)).astype(np.float32),
            "b": rng.standard_normal(8).astype(np.float32),
            "count": np.array(7, np.int32),
            "h": rng.standard_normal((3, 2)).astype(np.float32)}


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    tree = _flat_numpy()
    jtree = {k: jnp.asarray(v) for k, v in tree.items()}
    jtree["bf"] = jnp.asarray(tree["h"], jnp.bfloat16)
    JaxCheckpointStore(str(tmp_path)).save(5, jtree, extra={"loss": 2.0})
    like = {k: torch.zeros(v.shape, dtype=torch.from_numpy(v).dtype)
            for k, v in tree.items()}
    like["bf"] = torch.zeros(3, 2, dtype=torch.bfloat16)
    got, extra = CheckpointStore(str(tmp_path)).restore(like)
    assert extra == {"loss": 2.0}
    for k, v in tree.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
    assert torch.equal(got["bf"],
                       torch.tensor(tree["h"]).to(torch.bfloat16))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    tree = _flat_numpy(1)
    ttree = {k: torch.from_numpy(v) for k, v in tree.items()}
    ttree["bf"] = torch.from_numpy(tree["h"]).to(torch.bfloat16)
    CheckpointStore(str(tmp_path)).save(6, ttree, extra={"data_step": 6})
    like = {k: jnp.zeros(v.shape, v.dtype) for k, v in tree.items()}
    like["bf"] = jnp.zeros((3, 2), jnp.bfloat16)
    got, extra = JaxCheckpointStore(str(tmp_path)).restore(like)
    assert extra == {"data_step": 6}
    for k, v in tree.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v)
    np.testing.assert_array_equal(
        np.asarray(got["bf"], np.float32),
        ttree["bf"].float().numpy())


def test_training_modules_import_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "import repro_torch.training, repro_torch.launch.train\n"
        "import repro_torch.data.pipeline, repro_torch.checkpoint\n"
        "import repro_torch.kernels.flash_attention, repro_torch.tree\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)


def test_train_loop_resumes_from_its_checkpoint(tmp_path, capsys):
    """``launch/train.py``'s loop saves every ``ckpt_every`` steps (async)
    and, with ``resume``, continues from the newest checkpoint's step:
    its losses are the uninterrupted run's."""
    from repro_torch.launch.train import train_loop
    kw = dict(arch="llama3.2-1b", global_batch=2, seq_len=8, device="cpu",
              log_every=0)
    straight = train_loop(steps=4, **kw)
    first = train_loop(steps=2, ckpt_dir=str(tmp_path), ckpt_every=2, **kw)
    assert CheckpointStore(str(tmp_path)).latest_step() == 2
    resumed = train_loop(steps=4, ckpt_dir=str(tmp_path), ckpt_every=2,
                         resume=True, **kw)
    assert "resumed from step 2" in capsys.readouterr().out
    assert resumed["steps_run"] == 2
    # the 2-step run's schedule gives step 1 the 4-step run's lr scale (1)
    assert first["losses"] + resumed["losses"] == straight["losses"]
