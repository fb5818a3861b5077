"""The port's fault tolerance against the reference on the CPU: the
counterparts of ``tests/test_runtime.py`` (checkpoint round trip and
retention, the loss falls, failure recovery, straggler detection,
deterministic data), checkpoints moving both ways between the packages, and
`TrainRunner` following the reference runner's losses over the reference's
batches.

A reduced fp32 ``minitron_4b`` with the reference's weights. The two
runners' losses agree within 1e-4 relative over 12 steps: the step is the
same fp32 arithmetic, and Adam's ~lr sign(g) update lets a coordinate
whose gradient is ~0 move the other way (`tests/test_torch_train_step.py`),
which the later losses carry on at ~1e-6.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jax_load
from repro.checkpoint import save_checkpoint as jax_save
from repro.configs import get_reduced_config as jax_reduced
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import build_model as jax_build
from repro.optim import AdamW as JaxAdamW
from repro.optim import warmup_cosine as jax_warmup_cosine
from repro.runtime import TrainRunner as JaxTrainRunner
from repro_torch import bridge
from repro_torch import tree as tree_util
from repro_torch.checkpoint import latest_step, load_checkpoint, save_checkpoint
from repro_torch.configs import get_reduced_config
from repro_torch.data import BOS, SyntheticLM, make_batch
from repro_torch.launch.steps import make_train_step
from repro_torch.models import Model
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.runtime import TrainRunner

ARCH = "minitron_4b"


def _fp32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32", activ_dtype="float32")


@functools.lru_cache(maxsize=None)
def _reference():
    jcfg = _fp32(jax_reduced(ARCH))
    jmodel = jax_build(jcfg)
    return jmodel, jmodel.init_params(jax.random.PRNGKey(0))


def _port_setup(lr=None):
    """(model, opt_state, step_fn, dataset) on the CPU from the reference's weights."""
    _, jparams = _reference()
    cfg = _fp32(get_reduced_config(ARCH))
    params = bridge.params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    model = Model(cfg, params, device="cpu")
    opt = AdamW(lr=lr or warmup_cosine(1e-3, 5, 100))
    return (model, opt.init(model.params), make_train_step(model, opt),
            SyntheticLM(cfg.vocab_size, 32, 4, seed=0, device="cpu"))


def _runner(tmp_path, **kw):
    model, opt_state, step_fn, ds = _port_setup()
    return TrainRunner(step_fn=step_fn, params=model.params, opt_state=opt_state,
                       dataset=ds, ckpt_dir=tmp_path, **kw)


def _state(runner):
    return {"params": runner.params, "opt": runner.opt_state}


def test_checkpoint_roundtrip(tmp_path):
    runner = _runner(tmp_path)
    bf16 = {"w": torch.randn(3, 4).to(torch.bfloat16)}
    save_checkpoint(tmp_path, 3, {**_state(runner), "bf16": bf16})
    step, restored = load_checkpoint(tmp_path, {**_state(runner), "bf16": bf16}, device="cpu")
    assert step == 3
    for (na, a), (nb, b) in zip(tree_util.items(restored),
                                tree_util.items({**_state(runner), "bf16": bf16})):
        assert na == nb and a.dtype == b.dtype and torch.equal(a, b), na
    with pytest.raises(KeyError, match="missing leaf"):
        load_checkpoint(tmp_path, {"other": bf16}, device="cpu")
    with pytest.raises(FileNotFoundError):
        load_checkpoint(tmp_path / "none", bf16, device="cpu")


def test_checkpoint_retention(tmp_path):
    w = {"p": torch.ones(3)}
    for s in range(6):
        save_checkpoint(tmp_path, s, w, keep=2)
    steps = sorted(int(p.name.split("_")[1]) for p in tmp_path.iterdir())
    assert steps == [4, 5]
    assert latest_step(tmp_path) == 5
    save_checkpoint(tmp_path, 5, {"p": torch.zeros(3)})     # a raced save keeps the first
    assert torch.equal(load_checkpoint(tmp_path, w, device="cpu")[1]["p"], w["p"])
    assert not [p for p in tmp_path.iterdir() if p.name.startswith(".tmp_")]


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_checkpoints_move_between_the_packages(tmp_path, direction):
    """Either package loads the other's checkpoint: equal leaves and names,
    bf16 included (stored as fp32, cast back)."""
    jmodel, jparams = _reference()
    jstate = {"params": jparams, "opt": JaxAdamW().init(jparams),
              "bf16": {"w": jnp.arange(12, dtype=jnp.float32).reshape(3, 4).astype(jnp.bfloat16)}}
    model, opt_state, _, _ = _port_setup()
    tstate = {"params": model.params, "opt": opt_state,
              "bf16": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4).to(torch.bfloat16)}}
    if direction == "reference_to_port":
        jax_save(tmp_path, 7, jstate)
        step, got = load_checkpoint(tmp_path, tstate, device="cpu")
    else:
        save_checkpoint(tmp_path, 7, tstate)
        step, got = jax_load(tmp_path, jstate)
        got = tree_util.map_tree(lambda _, a: torch.from_numpy(np.array(a, np.float32)), got)
    assert step == 7
    import json
    manifest = json.loads((tmp_path / "step_00000007" / "manifest.json").read_text())
    names = [n for n, _ in tree_util.items(tstate)]
    assert manifest["names"] == names
    want = {"/".join(str(k.key) for k in p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(jstate)[0]}
    for name, t in tree_util.items(got):
        np.testing.assert_array_equal(t.float().numpy(), want[name], err_msg=name)
    if direction == "reference_to_port":
        assert got["bf16"]["w"].dtype == torch.bfloat16
        assert got["opt"]["count"].dtype == torch.int32


def test_loss_decreases(tmp_path):
    runner = _runner(tmp_path, ckpt_every=50)
    runner.run(30)
    assert np.mean(runner.losses[-5:]) < np.mean(runner.losses[:5])


def test_failure_recovery_resumes_from_checkpoint(tmp_path):
    runner = _runner(tmp_path, ckpt_every=5)
    with pytest.raises(RuntimeError, match="simulated node failure"):
        runner.run(20, fail_at=13)
    assert latest_step(tmp_path) == 10          # last periodic checkpoint
    out = runner.recover_and_run(20)
    assert out["steps"] == 20 and out["restarts"] == 1
    # the resumed steps 10..19 repeat the stream: steps 10..12 as before
    assert runner.losses[13:16] == runner.losses[10:13]


def test_straggler_detection(tmp_path):
    flagged = []
    runner = _runner(tmp_path, ckpt_every=100, mitigation_hook=flagged.append)
    runner.run(4)                                          # warm
    warm = runner.monitor.ewma
    runner.run(8, slow_steps={8: max(0.3, 4 * warm)})
    assert any(r.step == 8 for r in runner.monitor.flagged)
    assert flagged and flagged[0].slowdown > 2.0


def test_synthetic_lm_is_deterministic_and_keeps_the_law():
    """A batch is a pure function of (seed, step); ids lie in [2, V) with
    the u**4 skew towards low ids, BOS at ~1/mean_doc_len, and the loss
    mask drops exactly the BOS targets."""
    ds = SyntheticLM(vocab_size=1000, seq_len=256, global_batch=16, seed=1, device="cpu")
    b1, b2 = ds.batch_at(7), SyntheticLM(1000, 256, 16, seed=1, device="cpu").batch_at(7)
    assert torch.equal(b1["tokens"], b2["tokens"]) and torch.equal(b1["loss_mask"], b2["loss_mask"])
    assert not torch.equal(b1["tokens"], ds.batch_at(8)["tokens"])
    assert not torch.equal(b1["tokens"], SyntheticLM(1000, 256, 16, seed=2,
                                                     device="cpu").batch_at(7)["tokens"])
    tok = b1["tokens"]
    assert tok.shape == (16, 257) and tok.dtype == torch.int32
    assert b1["loss_mask"].shape == (16, 256) and b1["loss_mask"].dtype == torch.float32
    torch.testing.assert_close(b1["loss_mask"], (tok[:, 1:] != BOS).float())
    content = tok[tok != BOS]
    assert int(content.min()) >= 2 and int(content.max()) <= 999
    assert abs(float((tok == BOS).float().mean()) - 1 / 64) < 0.006
    # P(id < 2 + 998 q) = q ** 0.25 under the u**4 law
    for q in (0.01, 0.1, 0.5):
        share = float((content < 2 + 998 * q).float().mean())
        assert abs(share - q ** 0.25) < 0.03, (q, share)


def test_make_batch_adds_frames_and_positions():
    from repro_torch.configs.base import ShapeCell
    cell = ShapeCell("t", "train", 8, 2)
    whisper = get_reduced_config("whisper_large_v3")
    b = make_batch(whisper, cell, step=3, device="cpu")
    assert b["frames"].shape == (2, whisper.encdec.encoder_seq_len, whisper.d_model)
    assert b["frames"].dtype == torch.bfloat16
    assert torch.equal(b["frames"], make_batch(whisper, cell, step=3, device="cpu")["frames"])
    qwen_vl = get_reduced_config("qwen2_vl_2b")
    pos = make_batch(qwen_vl, cell, device="cpu")["positions"]
    assert pos.shape == (3, 2, 9) and torch.equal(pos[2, 1], torch.arange(9, dtype=torch.int32))


class _ReferenceBatches:
    """The reference's data stream, as the port's tensors."""

    def __init__(self, ds):
        self.ds = ds

    def batch_at(self, step):
        return {k: torch.tensor(np.asarray(v)) for k, v in self.ds.batch_at(step).items()}


def test_runner_follows_the_reference_runner(tmp_path):
    jmodel, jparams = _reference()
    jopt = JaxAdamW(lr=jax_warmup_cosine(1e-3, 5, 100))
    jds = JaxSyntheticLM(jmodel.cfg.vocab_size, 32, 4, seed=0)
    jrunner = JaxTrainRunner(step_fn=jax.jit(jax_make_train_step(jmodel, jopt)),
                             params=jparams, opt_state=jopt.init(jparams), dataset=jds,
                             ckpt_dir=tmp_path / "ref", ckpt_every=100)
    jrunner.run(12)
    model, opt_state, step_fn, _ = _port_setup()
    runner = TrainRunner(step_fn=step_fn, params=model.params, opt_state=opt_state,
                         dataset=_ReferenceBatches(jds), ckpt_dir=tmp_path / "port",
                         ckpt_every=100)
    runner.run(12)
    np.testing.assert_allclose(runner.losses, jrunner.losses, rtol=1e-4, atol=0)
    assert runner.losses[-1] < runner.losses[0]
