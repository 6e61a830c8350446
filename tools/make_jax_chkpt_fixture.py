#!/usr/bin/env python3
"""Write the JAX-checkpoint fixture that the PyTorch port serves.

    python tools/make_jax_chkpt_fixture.py [--out tests/fixtures/jax_chkpt]

The JAX package's own ``training/checkpoint.py::save_checkpoint`` writes
``chkpt_seed0.msgpack`` and its ``.meta.json`` sidecar, as the JAX CLI's
train phase does (``{"state": TrainState, "best_params"}``, AdamW state
included), for ``configs/beat-ours.json`` cut to d_model 64, 4 heads (the
fused kernel takes heads of 16 to 64 channels), 1 decoder layer and 4
joints (d_pose 12), with seeded weights: JAX's init,
biases, affine scales and BatchNorm statistics moved off their init
values.  The SE-ResNet trunk keeps its fixed 5.66 M parameters; its
kernels are drawn at three levels (0 and +-sqrt(3 / fan_in)) so that the
file, about 91 MB raw, is committed xz-compressed (``.msgpack.xz``, about
3 MB).  Beside it: ``config.json`` (the run's config, paths relative to
the run's directory) and ``sample.npz``, the JAX Generator's ddim50 sample
(scan path, float32) on a fixed batch of two 2 s wavs and fixed noise.
``write_fixture`` returns the raw bytes without compressing, for the test
that checks this script still reproduces the committed files.
"""

from __future__ import annotations

import argparse
import copy
import json
import lzma
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "fixtures", "jax_chkpt")
SEED, N, WINDOW, WAV = 0, 2, 40, 32000
JOINTS = ["Spine1", "Spine2", "Spine3", "RightShoulder"]


def fixture_config() -> dict:
    """beat-ours cut to the fixture's widths; synthetic data under
    ``spt``/``dst`` and the run under ``log`` (relative paths)."""
    with open(os.path.join(REPO, "configs", "beat-ours.json")) as f:
        raw = json.load(f)
    raw = copy.deepcopy(raw)
    raw["Data"].update({
        "synthetic": {"n_train": 4, "n_val": 4, "n_test": 2, "seconds": 4,
                      "n_joints": len(JOINTS)},
        "sample_duration": 4.0, "joints": JOINTS, "spt_dir_path": "spt",
        "dst_dir_path": "dst", "hierarchy_path": "hierarchy_upper.txt"})
    raw["Model"]["d_model"] = 64
    raw["Model"]["Decoder"].update({"heads": 4, "n_layers": 1})
    raw["Model"]["Diffusion"]["timestep_respacing"] = "ddim50"
    raw["Model"]["Generate"]["bpd_t_block"] = 2
    raw["Train"].update({"batch_size": 4, "max_training_steps": "4"})
    raw["Train"]["Scheduler"]["d_model"] = 64
    raw["Meta"] = {"project": "fixture", "log_dir": "log", "name": "jax_chkpt"}
    return raw


def _variables(model, rng):
    import jax
    import jax.numpy as jnp

    variables = jax.tree.map(np.asarray, model.init(
        jax.random.key(SEED), jnp.zeros((1, WINDOW, 3 * len(JOINTS))),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1, WAV)), train=False))

    def move(tree, trunk):
        for k, v in tree.items():
            if isinstance(v, dict):
                move(v, trunk or k == "resnet")
            elif k == "kernel" and trunk:
                fan_in = int(np.prod(v.shape[:-1]))
                level = np.float32(np.sqrt(3.0 / fan_in))
                tree[k] = (level * rng.integers(-1, 2, v.shape)).astype(np.float32)
            elif k in ("bias", "mean"):
                tree[k] = (v + rng.normal(0, 0.05, v.shape)).astype(np.float32)
            elif k in ("scale", "var"):
                tree[k] = (v * rng.uniform(0.8, 1.2, v.shape)).astype(np.float32)
        return tree

    return move(variables, False)


def write_fixture(out: str) -> dict:
    """Write config.json, the checkpoint (raw msgpack) with its sidecar
    and sample.npz into ``out``; :return: {file name: bytes} of the
    checkpoint and its sidecar."""
    import jax
    import jax.numpy as jnp
    import optax

    from gesture_diffusion_tpu.generation import Generator
    from gesture_diffusion_tpu.models import build_all
    from gesture_diffusion_tpu.training.checkpoint import save_checkpoint
    from gesture_diffusion_tpu.training.train_state import TrainState, init_opt_state
    from gesture_diffusion_tpu.utils import JsonConfig

    os.makedirs(out, exist_ok=True)
    raw = fixture_config()
    with open(os.path.join(out, "config.json"), "w") as f:
        json.dump(raw, f, indent=1)
    config = JsonConfig(os.path.join(out, "config.json"))
    d_pose = 3 * len(JOINTS)
    bundle = build_all(config, d_pose, is_training=False)
    rng = np.random.default_rng(SEED)
    variables = _variables(bundle.model, rng)
    params, stats = variables["params"], variables["batch_stats"]
    state = TrainState(params, stats, init_opt_state(optax.adamw(1e-3), params),
                       jnp.asarray(4, jnp.int32))
    path = os.path.join(out, "chkpt_seed0.msgpack")
    save_checkpoint(path, {"state": state, "best_params": params},
                    {"train_step": 4, "epochs_run": 1, "best_metric_value": 1.0,
                     "run_id": "fixture"})
    wav = rng.normal(0, 0.3, (N, WAV)).astype(np.float32)
    noise = rng.normal(size=(N, WINDOW, d_pose)).astype(np.float32)
    gen = Generator(bundle.model, {"params": params, "batch_stats": stats},
                    bundle.eval_schedule, bundle.eval_timestep_map, use_fused=False)
    sample = gen.generate_sample(jnp.asarray(wav), d_pose, WINDOW, jax.random.key(SEED),
                                 noise=jnp.asarray(noise))
    np.savez(os.path.join(out, "sample.npz"), wav=wav, noise=noise,
             sample=np.asarray(sample, np.float32))
    files = {}
    for name in ("chkpt_seed0.msgpack", "chkpt_seed0.msgpack.meta.json"):
        with open(os.path.join(out, name), "rb") as f:
            files[name] = f.read()
    return files


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=OUT)
    args = parser.parse_args()
    sys.path.insert(0, REPO)
    import jax

    # the fixture is written on the CPU, as the tests that read it run
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    files = write_fixture(args.out)
    raw_path = os.path.join(args.out, "chkpt_seed0.msgpack")
    with lzma.open(raw_path + ".xz", "wb", preset=6) as f:
        f.write(files["chkpt_seed0.msgpack"])
    os.remove(raw_path)
    print(f"{raw_path}.xz: {os.path.getsize(raw_path + '.xz')} bytes "
          f"({len(files['chkpt_seed0.msgpack'])} raw)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
