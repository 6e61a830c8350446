"""The port's ``Trainer`` on the CPU, at the size of tests/test_training.py:
the loss falls on its synthetic dataset, a resumed run continues exactly,
early stopping fires, checkpoints fail by name, ``train_steps`` and
``start_chkpt`` behave, and the metrics JSONL carries the JAX trainer's
keys (the JAX trainer is the oracle for those)."""

import json
import os

import jax
import numpy as np
import optax
import pytest
import torch

from gesture_diffusion_tpu.diffusion import make_schedule as jax_make_schedule
from gesture_diffusion_tpu.diffusion import linear_betas
from gesture_diffusion_tpu.models import DenoiserConfig as JaxConfig
from gesture_diffusion_tpu.models import GestureDenoiser as JaxDenoiser
from gesture_diffusion_tpu.parallel import make_mesh
from gesture_diffusion_tpu.training import ArrayDataset as JaxArrayDataset
from gesture_diffusion_tpu.training import Trainer as JaxTrainer
from gesture_diffusion_torch.diffusion import make_schedule
from gesture_diffusion_torch.models import DenoiserConfig, GestureDenoiser, build_all
from gesture_diffusion_torch.training import (
    ArrayDataset, Trainer, checkpoint_path, iter_batches, load_checkpoint,
    make_adamw, make_optimizer, read_checkpoint, save_checkpoint)
from gesture_diffusion_torch.utils import JsonConfig

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BETAS = np.asarray(linear_betas(50))
CFG = dict(d_pose=12, d_model=32, heads=4, n_layers=1)


def synthetic_arrays(n=32, t_pose=10, d_pose=12, t_wav=8000, seed=0):
    """tests/test_training.py's dataset: poses correlated with the wav."""
    rng = np.random.default_rng(seed)
    wav = rng.normal(0, 0.5, (n, t_wav)).astype(np.float32)
    base = wav[:, ::t_wav // (t_pose * d_pose)][:, : t_pose * d_pose]
    pose = 0.8 * base.reshape(n, t_pose, d_pose) + 0.1 * rng.normal(size=(n, t_pose, d_pose))
    return {"wav": wav, "pose": pose.astype(np.float32)}


def fresh_model(seed=0, **kw):
    torch.manual_seed(seed)
    return GestureDenoiser(DenoiserConfig(**CFG, **kw))


def make_trainer(log_dir, model=None, lr=3e-4, batch_size=16, wd=1e-4, **kw):
    model = fresh_model() if model is None else model
    return Trainer(model, make_schedule(BETAS),
                   make_adamw(model.parameters(), lr, wd), lambda s: lr,
                   ArrayDataset(synthetic_arrays()),
                   ArrayDataset(synthetic_arrays(n=16, seed=1)),
                   batch_size=batch_size, log_dir=str(log_dir), device="cpu", **kw)


def params_of(trainer):
    return {k: v.clone() for k, v in trainer.model.state_dict().items()}


def test_loss_decreases(tmp_path):
    trainer = make_trainer(tmp_path / "run", log_step_gap=1)
    trainer.train(max_epochs=8)
    records = trainer.logger.read_all()
    losses = [r["train/loss"] for r in records if "train/loss" in r]
    assert len(losses) == 16
    assert np.mean(losses[-4:]) < 0.9 * np.mean(losses[:4]), losses
    assert all(np.isfinite(r["val/loss"]) for r in records if "val/loss" in r)
    assert not trainer.model.training         # the val step ran last
    assert trainer.best_metric_value == min(r["val/loss"] for r in records
                                            if "val/loss" in r)


def test_checkpoint_resume_is_exact(tmp_path):
    straight = make_trainer(tmp_path / "a")
    straight.train(max_epochs=4)
    first = make_trainer(tmp_path / "b")
    first.train(max_epochs=2)
    resumed = make_trainer(tmp_path / "b", model=fresh_model(seed=1))
    assert resumed.epochs_run == 2
    assert resumed.train_step_count == first.train_step_count == 4
    assert resumed.run_id == first.run_id
    for k, v in params_of(first).items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    resumed.train(max_epochs=4)
    ours, ref = params_of(resumed), params_of(straight)
    for k in ref:
        assert torch.equal(ours[k], ref[k]), k
    assert resumed.best_metric_value == straight.best_metric_value
    for k, v in straight.best_params.items():
        assert torch.equal(resumed.best_params[k], v), k
    meta = json.load(open(checkpoint_path(str(tmp_path / "b"), 0) + ".meta.json"))
    assert meta["train_step"] == 8 and meta["epochs_run"] == 4


def test_early_stopping(tmp_path):
    trainer = make_trainer(tmp_path / "es", lr=0.0, wd=0.0)
    trainer.train(max_epochs=50, early_stop_threshold=2)
    # lr 0: the weights stay, and only the BN statistics and the val draws
    # move the val loss; two epochs without a new best stop the run
    assert trainer.early_stop and trainer.early_stop_counter == 2
    assert trainer.epochs_run < 50
    vals = [r["val/loss"] for r in trainer.logger.read_all() if "val/loss" in r]
    assert len(vals) == trainer.epochs_run and min(vals[-2:]) >= min(vals[:-2])


def test_train_steps_equals_single_steps(tmp_path):
    """``train_steps`` over a list of batches gives the numbers of one call
    per batch, and logs every step after the last one."""
    batches = list(iter_batches(ArrayDataset(synthetic_arrays()), 8, shuffle=False))
    single = make_trainer(tmp_path / "one", log_step_gap=1)
    for batch in batches:
        single.train_steps([batch])
    multi = make_trainer(tmp_path / "four", log_step_gap=1)
    out = multi.train_steps(batches)
    assert len(out) == 4 and multi.train_step_count == single.train_step_count == 4
    a, b = params_of(single), params_of(multi)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    recs = [r for r in multi.logger.read_all() if "train/loss" in r]
    assert [r["train/step"] for r in recs] == list(range(4))
    ref = [r for r in single.logger.read_all() if "train/loss" in r]
    assert [r["train/loss"] for r in recs] == [r["train/loss"] for r in ref]
    assert [r["train/loss"] for r in recs] == [float(m["loss"]) for m in out]


def test_loss_aware_sampler(tmp_path):
    trainer = make_trainer(tmp_path / "ls", log_step_gap=1,
                           schedule_sampler="loss-second-moment")
    trainer.train(max_epochs=2)
    assert trainer.sampler._loss_counts.sum() == 4 * 16
    recs = [r for r in trainer.logger.read_all() if "train/loss" in r]
    assert len(recs) == 4 and all("train/mse_per_example" not in r for r in recs)


def test_corrupt_checkpoint_named_error(tmp_path):
    model = fresh_model()
    path = str(tmp_path / "chkpts" / "chkpt_seed0.pt")
    os.makedirs(os.path.dirname(path))
    with open(path, "wb") as f:
        f.write(b"\x00garbage\xff" * 20)
    with pytest.raises(ValueError, match="chkpt_seed0.pt.*corrupt.*move it aside"):
        read_checkpoint(path)

    save_checkpoint(path, {"model": model.state_dict()}, {"step": 3})
    raw = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(raw[: len(raw) // 2])
    with pytest.raises(ValueError, match="chkpt_seed0.pt.*corrupt.*move it aside"):
        load_checkpoint(path, {"model": model})

    save_checkpoint(path, {"model": model.state_dict()}, {"step": 3})
    with open(path + ".meta.json", "w") as f:
        f.write("{bad")
    with pytest.raises(ValueError, match="meta.json.*move it aside"):
        read_checkpoint(path)
    with open(path + ".meta.json", "w") as f:
        f.write('{"step": 3}')

    # an intact file of another structure: keep it, fix the config
    other = GestureDenoiser(DenoiserConfig(d_pose=12, d_model=16, heads=4, n_layers=1))
    with pytest.raises(ValueError, match="chkpt_seed0.pt.*does not match.*intact"):
        load_checkpoint(path, {"model": other})
    with pytest.raises(ValueError, match="does not match"):
        load_checkpoint(path, {"model": model, "optimizer": make_adamw(
            model.parameters(), 1e-3, 0.0)})
    with pytest.raises(ValueError, match="does not match"):
        load_checkpoint(path, {"model": other.state_dict()})
    tree, meta = load_checkpoint(path, {"model": model})
    assert meta == {"step": 3} and set(tree) == {"model"}
    assert not os.path.exists(path + ".tmp")

    # the trainer refuses to resume from a torn checkpoint of its own
    with open(path, "wb") as f:
        f.write(raw[:100])
    with pytest.raises(ValueError, match="chkpt_seed0.pt"):
        make_trainer(tmp_path)


def test_start_chkpt_merges_by_name_and_shape(tmp_path):
    donor = make_trainer(tmp_path / "donor")
    donor.train(max_epochs=1)
    # another pose width: the pose-side layers keep their fresh values
    target = GestureDenoiser(DenoiserConfig(d_pose=9, d_model=32, heads=4, n_layers=1))
    fresh = {k: v.clone() for k, v in target.state_dict().items()}
    data = synthetic_arrays(d_pose=9)
    trainer = Trainer(target, make_schedule(BETAS),
                      make_adamw(target.parameters(), 1e-3, 0.0), lambda s: 1e-3,
                      ArrayDataset(data), ArrayDataset(data), 16,
                      str(tmp_path / "ft"), device="cpu",
                      start_chkpt=donor.chkpt_path)
    got = trainer.model.state_dict()
    donor_best = donor.best_params
    copied = [k for k in got if torch.equal(got[k], donor_best[k])
              and not torch.equal(got[k], fresh[k])]
    kept = [k for k in got if donor_best[k].shape != got[k].shape]
    assert "pose_decoder.emb_x.weight" in kept and "pose_decoder.out_layers.1.bias" in kept
    for k in kept:
        assert torch.equal(got[k], fresh[k]), k
    assert "speech_encoder.wav_encoder.feat_extractor.conv1.weight" in copied
    assert len(copied) + len(kept) >= len(got) - 40   # BN counters, equal LN inits


def test_jsonl_keys_are_the_jax_loggers(tmp_path):
    """One epoch each with log_step_gap 1 and all three speed losses: the
    same record keys, train and val."""
    loss_params = {"speed_loss": 0.1, "speed_l1_loss": 0.1,
                   "speed_constraint_loss": 0.01}
    data, val = synthetic_arrays(n=16), synthetic_arrays(n=8, seed=1)
    ours = Trainer(fresh_model(), make_schedule(BETAS),
                   make_adamw(fresh_model().parameters(), 1e-3, 0.0), lambda s: 1e-3,
                   ArrayDataset(data), ArrayDataset(val), 8, str(tmp_path / "port"),
                   log_step_gap=1, loss_params=loss_params, device="cpu",
                   config={"Meta": {"name": "x"}})
    ours.train(max_epochs=1)
    ref = JaxTrainer(JaxDenoiser(JaxConfig(**CFG)), jax_make_schedule(BETAS),
                     optax.adamw(1e-3), lambda s: 1e-3, JaxArrayDataset(data),
                     JaxArrayDataset(val), 8, str(tmp_path / "jax"), log_step_gap=1,
                     loss_params=loss_params, mesh=make_mesh(n_data=1),
                     config={"Meta": {"name": "x"}})
    ref.train(max_epochs=1)

    def keys(trainer, prefix):
        return [sorted(r) for r in trainer.logger.read_all()
                if any(k.startswith(prefix) for k in r)]

    for prefix in ("train/", "val/"):
        got, want = keys(ours, prefix), keys(ref, prefix)
        assert got == want and len(got) > 0, (prefix, got, want)
    for name in ("config.json", f"run_{ours.run_id}.config.json",
                 f"metrics_{ours.run_id}.jsonl", "chkpts/chkpt_seed0.pt",
                 "chkpts/chkpt_seed0.pt.meta.json"):
        assert os.path.exists(tmp_path / "port" / name), name


def test_bundle_builds_the_flagship_optimizer():
    """beat-ours: AdamW at weight_decay 0 (not torch's 0.01) and optax's
    betas and eps, with the noamxf learning rate read at update 0."""
    cfg = JsonConfig(os.path.join(REPO, "configs", "beat-ours.json"))
    b = build_all(cfg, 123, device="cpu", generator=torch.Generator().manual_seed(0),
                  encoder_dtype="bfloat16")
    opt, lr_schedule = make_optimizer(b.model, cfg.Train)
    group = opt.param_groups[0]
    assert (group["weight_decay"], group["betas"], group["eps"]) == (0.0, (0.9, 0.999), 1e-8)
    assert group["lr"] == lr_schedule(0) == pytest.approx(256 ** -0.5 * 4000 ** -1.5)
    assert sum(p.numel() for g in opt.param_groups for p in g["params"]) == 10_340_087
    assert b.model.cfg.encoder_dtype == "bfloat16"
    assert b.model.speech_encoder.encoder_dtype is torch.bfloat16
    # no Train block: lr 1e-2, no decay, as the JAX build_all
    opt, lr_schedule = make_optimizer(b.model, None)
    assert lr_schedule(5) == 1e-2 and opt.param_groups[0]["weight_decay"] == 0.0
