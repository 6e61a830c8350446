"""The port's phase CLI end to end on the CPU, against the JAX package's
artifacts.

``python -m gesture_diffusion_torch.cli --phase ... --device cpu`` over a
smoke-sized copy of ``configs/beat-ours.json`` (d_model 32, 1 layer, 50
diffusion steps sampled as ddim10, 4 joints of the golden skeleton, with a
``hierarchy_path`` so the eval phase computes the beat metrics), all six
phases in order, in-process through ``main(argv)``.  The data phase's
arrays are held against the JAX package's ``load_processed_datasets`` on
the same samples pickle (1e-5).  The JAX CLI's train phase is not rerun
here (``tests/test_cli.py`` runs it); the other phases are held by the
JAX CLI's artifact names and keys.  Noise differs by design (torch
generators seeded from ``Meta.seed``), so outputs are held by shape,
finiteness and keys.
"""

import contextlib
import io
import json
import os
import pickle
import subprocess
import sys
import tomllib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gesture_diffusion_tpu.data import pipeline as jax_pipeline
from gesture_diffusion_tpu.diffusion import bpd_loop as jax_bpd_loop
from gesture_diffusion_tpu.diffusion import make_diffusion as jax_make_diffusion
from gesture_diffusion_torch import cli
from gesture_diffusion_torch.data.bvh import parse_bvh
from gesture_diffusion_torch.training import read_checkpoint, save_checkpoint

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOINTS = ["Spine1", "Spine2", "Spine3", "RightShoulder"]
# equal split sizes: the JAX data phase runs op by op, and one shape
# compiles each op once
SECONDS, N_SPLIT = 4, 4
DATA_TOL = 1e-5
PHASE_ORDER = ("prep", "data", "train", "eval", "eval-time", "gen")


def _smoke_config(tmp) -> dict:
    with open(os.path.join(REPO, "configs", "beat-ours.json")) as f:
        raw = json.load(f)
    raw["Data"].update({
        "synthetic": {"n_train": N_SPLIT, "n_val": N_SPLIT, "n_test": N_SPLIT,
                      "seconds": SECONDS, "n_joints": len(JOINTS)},
        "sample_duration": float(SECONDS), "joints": JOINTS,
        "spt_dir_path": str(tmp / "spt"), "dst_dir_path": str(tmp / "dst"),
        "hierarchy_path": str(tmp / "hierarchy_upper.txt")})
    raw["Model"]["d_model"] = 32
    raw["Model"]["Decoder"].update({"heads": 4, "n_layers": 1})
    raw["Model"]["Diffusion"].update({"diffusion_steps": 50,
                                      "timestep_respacing": "ddim10"})
    # the shipped bpd_t_block (4) must divide the respaced 10 steps
    raw["Model"]["Generate"]["bpd_t_block"] = 2
    raw["Train"].update({"batch_size": 4, "max_training_steps": "4",
                         "early_stop_threshold_in_step": "4"})
    raw["Train"]["Scheduler"]["d_model"] = 32
    raw["Meta"] = {"project": "smoke", "log_dir": str(tmp / "log"), "name": "smoke"}
    return raw


def _write(tmp, raw, name="cfg.json") -> str:
    path = str(tmp / name)
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def _run(argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    return out.getvalue()


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """The six phases in order; the hierarchy template is the golden BVH
    pruned as ``ensure_hierarchy_template`` prunes a corpus BVH."""
    tmp = tmp_path_factory.mktemp("cli")
    raw = _smoke_config(tmp)
    with open(raw["Data"]["hierarchy_path"], "w") as f:
        f.write(cli.hierarchy_template(
            os.path.join(REPO, "tests", "golden", "synth_fullbody.bvh"), JOINTS,
            raw["Data"]["hierarchy_extra_joints"]))
    cfg = _write(tmp, raw)
    printed = {phase: _run(["--phase", phase, "--config", cfg, "--device", "cpu"])
               for phase in PHASE_ORDER}
    return tmp, raw, printed


def _pkl(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def test_data_phase_matches_jax(cli_run):
    tmp, raw, _ = cli_run
    d = raw["Data"]
    ref = jax_pipeline.load_processed_datasets(
        pose_fps=d["pose_fps"], wav_sr=d["wav_sr"], spt_dir_path=d["spt_dir_path"],
        dst_dir_path=str(tmp / "jax_dst"), pose_window_len=d["pose_window_len"],
        pose_stride_len=d["pose_stride_len"],
        pose_representation=d["pose_representation"])
    dst, jax_dst = tmp / "dst", tmp / "jax_dst"
    assert sorted(os.listdir(dst)) == sorted(os.listdir(jax_dst)) == sorted([
        "train_data.pkl", "val_data.pkl", "test_data.pkl", "test_seqs.pkl",
        "scaler.npz", "scaler_params.json"])
    for split, ds in zip(("train", "val", "test"), ref):
        ours = _pkl(dst / f"{split}_data.pkl")
        theirs = _pkl(jax_dst / f"{split}_data.pkl")
        assert ours.keys() == theirs.keys() and ours["params"] == theirs["params"]
        assert isinstance(ours["pose"], np.ndarray)
        assert ours["pose"].shape == theirs["pose"].shape == (
            ds.poses.shape[0], 40, 3 * len(JOINTS))
        assert np.abs(ours["pose"] - theirs["pose"]).max() < DATA_TOL
        np.testing.assert_array_equal(ours["wav"], theirs["wav"])
    seqs, seqs_ref = _pkl(dst / "test_seqs.pkl"), _pkl(jax_dst / "test_seqs.pkl")
    assert seqs.keys() == seqs_ref.keys()
    assert seqs["pose"].shape == (N_SPLIT, SECONDS * 20, 3 * len(JOINTS))
    assert np.abs(seqs["pose"] - seqs_ref["pose"]).max() < DATA_TOL
    with np.load(dst / "scaler.npz") as a, np.load(jax_dst / "scaler.npz") as b:
        assert np.abs(a["mean"] - b["mean"]).max() < DATA_TOL
        assert np.abs(a["scale"] - b["scale"]).max() < DATA_TOL * np.abs(b["scale"]).max()


def test_train_phase_artifacts(cli_run):
    tmp, _, printed = cli_run
    log = tmp / "log" / "smoke"
    chkpt = log / "chkpts" / "chkpt_seed0.pt"
    meta = json.loads((log / "chkpts" / "chkpt_seed0.pt.meta.json").read_text())
    assert chkpt.exists() and meta["epochs_run"] == 1 and meta["train_step"] == 4
    tree = torch.load(chkpt, weights_only=True)
    assert set(tree) == {"model", "optimizer", "best_params", "step"}
    assert "Max epochs: 1" in printed["train"]
    records = [json.loads(line) for line in
               (log / f"metrics_{meta['run_id']}.jsonl").read_text().splitlines()]
    assert {"train/loss", "train/grad_norm", "train/lr"} <= set(records[0])
    assert sum("val/loss" in r for r in records) == 1
    assert json.loads((log / "config.json").read_text())["Meta"]["seed"] == 0


def test_eval_phase_keys_and_outputs(cli_run):
    """The JAX CLI's eval_results.json keys: the bpd terms (the JAX
    ``bpd_loop``'s own keys) and the two beat metrics, all finite."""
    tmp, _, printed = cli_run
    sched, tmap = jax_make_diffusion("linear", 1000, "2")
    terms = jax_bpd_loop(sched, lambda x, t: jnp.zeros_like(x), jnp.zeros((1, 2, 3)),
                         jax.random.key(0), tmap)
    results_dir = tmp / "log" / "smoke" / "results"
    results = json.loads((results_dir / "eval_results.json").read_text())
    assert set(results) == {f"test/{k}" for k in terms} | {
        "test/beat_consistency", "test/beat_recall"}
    assert np.isfinite(list(results.values())).all()
    gen = _pkl(results_dir / "generated.pkl")
    assert gen["out"].shape == gen["pose"].shape == (N_SPLIT * SECONDS * 20 // 40, 40, 12)
    assert np.isfinite(gen["out"]).all()
    meta = json.loads((tmp / "log" / "smoke" / "chkpts" /
                       "chkpt_seed0.pt.meta.json").read_text())
    last = json.loads((tmp / "log" / "smoke" / f"metrics_{meta['run_id']}.jsonl"
                       ).read_text().splitlines()[-1])
    assert {k: last[k] for k in results} == results
    assert "Batch 1/1" in printed["eval"]


def test_eval_pairs_best_params_with_the_last_batch_stats(cli_run, tmp_path):
    """load_eval_objs serves ``best_params`` with the last state's
    BatchNorm statistics, as the JAX CLI pairs ``best_params`` with
    ``state.batch_stats``."""
    tmp, raw, _ = cli_run
    tree, meta = read_checkpoint(str(tmp / "log" / "smoke" / "chkpts" / "chkpt_seed0.pt"))
    bn = [k for k in tree["model"] if k.endswith(("running_mean", "running_var"))]
    weights = [k for k in tree["model"] if k.endswith("weight")]
    assert len(bn) == 2 * 39 and weights
    last = {k: v + 1.0 if k in bn or k == weights[0] else v
            for k, v in tree["model"].items()}
    raw = {**raw, "Meta": {**raw["Meta"], "log_dir": str(tmp_path)}}
    save_checkpoint(str(tmp_path / "smoke" / "chkpts" / "chkpt_seed0.pt"),
                    {**tree, "model": last}, meta)
    config = cli.JsonConfig(_write(tmp_path, raw))
    config.set("Meta.seed", 0)
    _, _, generator = cli.load_eval_objs(config, device="cpu")
    served = generator.model.state_dict()
    for k in bn:
        torch.testing.assert_close(served[k], last[k], rtol=0, atol=0)
    torch.testing.assert_close(served[weights[0]], tree["best_params"][weights[0]],
                               rtol=0, atol=0)


def test_eval_time_and_gen_phases(cli_run):
    tmp, raw, printed = cli_run
    assert "path=fused" in printed["eval-time"]
    samples = tmp / "log" / "smoke" / "results" / "samples"
    assert sorted(os.listdir(samples)) == [f"sample_{i}.pkl" for i in range(N_SPLIT)]
    seqs = _pkl(tmp / "dst" / "test_seqs.pkl")
    for i in range(N_SPLIT):
        s = _pkl(samples / f"sample_{i}.pkl")
        assert s["out"].shape == s["pose"].shape == (SECONDS * 20, 3 * len(JOINTS))
        assert np.isfinite(s["out"]).all()
        np.testing.assert_array_equal(s["wav"], seqs["wav"][i])
        # euler degrees, converted back from the scaled log-rotation
        assert np.abs(s["pose"]).max() <= 180.0 + 1e-3
        assert np.abs(s["pose"]).max() > 10.0
    # the same seed gives the same sequence
    before = _pkl(samples / "sample_0.pkl")["out"]
    _run(["--phase", "gen", "--config", str(tmp / "cfg.json"), "--device", "cpu"])
    np.testing.assert_array_equal(_pkl(samples / "sample_0.pkl")["out"], before)


@pytest.mark.parametrize("path,value,match", [
    ("Train.world_size", 0, "world_size"),
    ("Model.Encoder.type", "wav2vec2", "Unsupported encoder"),
    ("Model.Decoder.type", "transformer", "Unsupported decoder"),
])
def test_unported_settings_raise(tmp_path, path, value, match):
    """Refused by every phase that builds a model, before it writes
    anything, through main() and by the phase functions themselves.  Every
    decoder and encoder the JAX factory builds is ported, so the types
    refused are ones the JAX factory refuses too."""
    raw = _smoke_config(tmp_path)
    node = raw
    *parents, leaf = path.split(".")
    for key in parents:
        node = node.setdefault(key, {})
    node[leaf] = value
    cfg = _write(tmp_path, raw)
    for phase in ("train", "eval", "eval-time", "gen"):
        with pytest.raises(ValueError, match=match):
            cli.main(["--phase", phase, "--config", cfg, "--device", "cpu"])
    config = cli.JsonConfig(cfg)
    config.set("Meta.seed", 0)
    for fn in (cli.train_model, cli.evaluate, cli.eval_infer_time, cli.generate):
        with pytest.raises(ValueError, match=match):
            fn(config, device="cpu")
    assert not os.path.exists(raw["Data"]["spt_dir_path"])
    assert not os.path.exists(raw["Meta"]["log_dir"])


def test_train_dtype_trains_and_serves(tmp_path):
    """``Train.dtype: "bfloat16"`` (the whole model in bf16, which the CLI
    once refused) runs prep -> data -> train -> gen: the step computes in
    bf16 on float32 parameters, which the checkpoint holds, and gen serves
    them through the fused path as the JAX CLI does (its eval builds the
    model without ``dtype``)."""
    raw = _smoke_config(tmp_path)
    raw["Train"]["dtype"] = "bfloat16"
    with open(raw["Data"]["hierarchy_path"], "w") as f:
        f.write(cli.hierarchy_template(
            os.path.join(REPO, "tests", "golden", "synth_fullbody.bvh"), JOINTS,
            raw["Data"]["hierarchy_extra_joints"]))
    cfg = _write(tmp_path, raw)
    built = []
    real_build_all = cli.build_all

    def build_all(*args, **kw):
        bundle = real_build_all(*args, **kw)
        built.append(bundle.model.cfg.dtype)
        return bundle

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "build_all", build_all)
        printed = {phase: _run(["--phase", phase, "--config", cfg, "--device", "cpu"])
                   for phase in ("prep", "data", "train", "gen")}
    assert built == ["bfloat16", None]
    log = tmp_path / "log" / "smoke"
    tree, _ = read_checkpoint(str(log / "chkpts" / "chkpt_seed0.pt"))
    assert {v.dtype for v in tree["model"].values() if v.is_floating_point()} \
        == {torch.float32}
    (metrics,) = log.glob("metrics_*.jsonl")
    losses = [json.loads(line)["train/loss"] for line in
              metrics.read_text().splitlines() if "train/loss" in line]
    assert losses and np.isfinite(losses).all()
    samples = log / "results" / "samples"
    assert len(os.listdir(samples)) == N_SPLIT
    out = _pkl(samples / "sample_0.pkl")["out"]
    assert out.shape == (SECONDS * 20, 3 * len(JOINTS)) and np.isfinite(out).all()
    assert "Epoch" in printed["train"]


def test_prep_without_synthetic_and_eval_without_checkpoint(tmp_path):
    """Without ``Data.synthetic``, prep reads the BEAT corpus: a missing
    ``src_dir_path`` fails with the JAX package's message, and a non-empty
    ``spt_dir_path`` is not written over."""
    raw = _smoke_config(tmp_path)
    del raw["Data"]["synthetic"]
    raw["Data"]["src_dir_path"] = str(tmp_path / "no-corpus")
    with pytest.raises(FileNotFoundError, match="Source data not found"):
        cli.main(["--phase", "prep", "--config", _write(tmp_path, raw), "--device", "cpu"])
    assert not os.path.exists(raw["Data"]["spt_dir_path"])
    os.makedirs(tmp_path / "no-corpus")
    os.makedirs(raw["Data"]["spt_dir_path"])
    (tmp_path / "spt" / "notes.txt").write_bytes(b"kept")
    with pytest.raises(FileExistsError, match="Manually remove"):
        cli.main(["--phase", "prep", "--config", _write(tmp_path, raw), "--device", "cpu"])
    assert os.listdir(tmp_path / "spt") == ["notes.txt"]
    raw = _smoke_config(tmp_path)
    cfg = _write(tmp_path, raw, "synthetic.json")
    with pytest.raises(FileNotFoundError, match="run --phase train first"):
        cli.main(["--phase", "eval", "--config", cfg, "--device", "cpu"])


def test_main_argv_wiring(tmp_path, monkeypatch, capsys):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"Data": {"wav_sr": 16000}}))
    seen = {}
    monkeypatch.setitem(cli.PHASES, "prep",
                        lambda config, device: seen.update(config=config, device=device))
    cli.main(["--phase", "prep", "--config", str(cfg), "--seed", "7", "--device", "cpu"])
    config = seen["config"]
    assert (config.Meta.phase, config.Meta.seed, config.Meta.config_path) == \
        ("prep", 7, str(cfg))
    assert config.Meta.name == "cfg" and config.Data.wav_sr == 16000
    assert seen["device"] == torch.device("cpu")
    with pytest.raises(ValueError, match="bogus"):
        cli.main(["--phase", "bogus", "--config", str(cfg), "--device", "cpu"])
    with pytest.raises(SystemExit) as exc:
        cli.main([])
    assert exc.value.code == 2 and "--phase" in capsys.readouterr().err


def test_module_entry_and_console_script():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    assert scripts["gesture-diffusion-torch"] == "gesture_diffusion_torch.cli:main"
    assert scripts["gesture-diffusion"] == "gesture_diffusion_tpu.cli:main"
    out = subprocess.run([sys.executable, "-m", "gesture_diffusion_torch.cli", "--help"],
                         capture_output=True, text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert all(flag in out.stdout for flag in ("--phase", "--config", "--seed", "--device"))


# -- the TED-Expressive configuration, scaled down -----------------------------

TED_JOINTS, TED_SECONDS = 42, 8
TED_SPLITS = {"n_train": 2, "n_val": 2, "n_test": 6}


def _tedexp_config(tmp) -> dict:
    """``configs/tedexp-ours.json`` with 2 layers at d_model 64, 50
    diffusion steps sampled as ddim10, batch 4 for 2 steps, and
    ``Data.synthetic``: 42 joints in euler (d_pose 126, the configuration's
    width), 2/2/6 samples of 8 s at 15 fps; no ``hierarchy_path``, so eval
    skips the beat metrics and gen writes the euler poses as they are.  The
    FGD net trains 20 steps with a latent of 8 (18 test windows)."""
    with open(os.path.join(REPO, "configs", "tedexp-ours.json")) as f:
        raw = json.load(f)
    raw["Data"].update({
        "synthetic": {**TED_SPLITS, "seconds": TED_SECONDS,
                      "n_joints": TED_JOINTS},
        "sample_duration": float(TED_SECONDS),
        "spt_dir_path": str(tmp / "spt"), "dst_dir_path": str(tmp / "dst")})
    raw["Model"]["d_model"] = 64
    raw["Model"]["Decoder"]["n_layers"] = 2
    raw["Model"]["Diffusion"].update({"diffusion_steps": 50,
                                      "timestep_respacing": "ddim10"})
    raw["Model"]["Generate"]["bpd_t_block"] = 2
    raw["Train"].update({"batch_size": 4, "max_training_steps": "2",
                         "early_stop_threshold_in_step": "2"})
    raw["Eval"]["fgd"].update({"eval_net_path": str(tmp / "fgd" / "fgd_ae.msgpack"),
                               "latent_dim": 8, "train_steps": 20})
    raw["Meta"] = {"project": "smoke", "log_dir": str(tmp / "log"), "name": "tedexp"}
    return raw


def test_tedexp_six_phases(tmp_path):
    """prep -> data -> train -> eval -> eval-time -> gen on the
    cross-attention decoder: eval writes finite FGD, latent distance and
    diversity beside the bpd terms, eval-time times the scan sampler, gen
    writes every test sequence."""
    raw = _tedexp_config(tmp_path)
    cfg = _write(tmp_path, raw)
    printed = {phase: _run(["--phase", phase, "--config", cfg, "--device", "cpu"])
               for phase in PHASE_ORDER}
    log = tmp_path / "log" / "tedexp"
    assert (log / "chkpts" / "chkpt_seed0.pt").exists()
    results = json.loads((log / "results" / "eval_results.json").read_text())
    fgd_keys = {"test/fgd", "test/feat_dist", "test/diversity"}
    assert fgd_keys <= set(results)
    assert not {"test/beat_consistency", "test/beat_recall"} & set(results)
    assert np.isfinite(list(results.values())).all()
    assert results["test/fgd"] < 1e10       # not the failed-sqrtm sentinel
    assert (tmp_path / "fgd" / "fgd_ae.pt").exists()
    assert "path=scan" in printed["eval-time"]
    d_pose = 3 * TED_JOINTS
    gen = _pkl(log / "results" / "generated.pkl")
    assert gen["out"].shape == gen["pose"].shape
    assert gen["out"].shape[1:] == (34, d_pose) and np.isfinite(gen["out"]).all()
    samples = log / "results" / "samples"
    assert len(os.listdir(samples)) == TED_SPLITS["n_test"]
    s = _pkl(samples / "sample_0.pkl")
    assert s["out"].shape == s["pose"].shape == (TED_SECONDS * 15, d_pose)
    assert np.isfinite(s["out"]).all()
