"""The JAX package's checkpoints in the port, on the CPU.

``interop/flax_msgpack.py`` decodes what ``flax.serialization.to_bytes``
and ``msgpack.packb`` write, held against ``msgpack_restore`` on a tree of
every dtype a checkpoint holds (chunked arrays too), without importing
``msgpack``, ``flax`` or ``jax``.  A checkpoint that JAX's
``save_checkpoint`` writes here at ``configs/beat-ours.json``'s full width
loads into the port bit for bit and is served by both packages' Generators
(the scan path, ddim10) on the same noise within 2e-5.  The committed
fixture (``tools/make_jax_chkpt_fixture.py``: beat-ours cut to d_model 64,
xz-compressed) is still what the script writes, is served within 2e-5 of
the JAX sample recorded beside it, runs through the CLI's eval-time and gen
phases with no ``.pt`` beside it, and starts a fine-tuning run
(``Model.start_chkpt``) as the JAX trainer reads one.
"""

import json
import lzma
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from gesture_diffusion_tpu.generation import Generator as JaxGenerator
from gesture_diffusion_tpu.interop.torch_import import import_torch_state_dict
from gesture_diffusion_tpu.models import build_all as jax_build_all
from gesture_diffusion_tpu.training.checkpoint import save_checkpoint as jax_save
from gesture_diffusion_tpu.training.train_state import TrainState, init_opt_state
from gesture_diffusion_tpu.utils import JsonConfig as JaxJsonConfig
from gesture_diffusion_torch import cli
from gesture_diffusion_torch.generation import Generator
from gesture_diffusion_torch.interop import (flax_msgpack, jax_checkpoint_state_dict,
                                             jax_params_state_dict, state_dict_from_jax)
from gesture_diffusion_torch.models import build_all
from gesture_diffusion_torch.training import load_start_params
from gesture_diffusion_torch.utils import JsonConfig
from torch_port_common import _perturb, rel_err

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "jax_chkpt"
SERVE_TOL = 2e-5
sys.path.insert(0, str(REPO / "tools"))
import make_jax_chkpt_fixture as fixture_script  # noqa: E402


def _same(ours, ref, path="") -> None:
    """Equal trees: the same keys, list lengths, scalar values and types,
    and arrays of the same shape and values (bfloat16 read as float32)."""
    if isinstance(ref, dict):
        assert isinstance(ours, dict) and list(ours) == list(ref), path
        for k in ref:
            _same(ours[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, (list, tuple)):
        assert isinstance(ours, list) and len(ours) == len(ref), path
        for i, (a, b) in enumerate(zip(ours, ref)):
            _same(a, b, f"{path}/{i}")
    elif isinstance(ref, np.ndarray):
        expected = np.asarray(ref, np.float32) if ref.dtype == jnp.bfloat16 else ref
        assert isinstance(ours, np.ndarray) and ours.dtype == expected.dtype, path
        np.testing.assert_array_equal(ours, expected, err_msg=path)
    else:
        assert type(ours) is type(ref) and (ours == ref or ours != ours), path


def _every_dtype(rng):
    tree = {f"a_{np.dtype(d).name}": (rng.normal(size=(3, 5)) * 100).astype(d)
            for d in (np.float16, np.float32, np.float64, np.int8, np.int16,
                      np.int32, np.int64, np.uint8, np.uint16, np.uint32,
                      np.uint64, np.complex64)}
    tree.update({
        "bool": rng.integers(0, 2, (4,)).astype(bool),
        "bf16": np.asarray(jnp.asarray(rng.normal(size=(2, 7)), jnp.bfloat16)),
        "scalar_f32": np.float32(1.5), "scalar_i64": np.int64(-(2 ** 40)),
        "zero_d": np.zeros((), np.int32), "empty": np.zeros((0, 3), np.float32),
        "nested": {"params": {f"layer{i}": {"kernel": rng.normal(size=(i + 1, 2)),
                                           "bias": np.arange(i, dtype=np.float32)}
                              for i in range(20)}},
        "step": 7, "neg": -3, "big": 2 ** 63 - 1, "small": -(2 ** 63), "u": 2 ** 64 - 1,
        "f": 0.1, "none": None, "t": True, "s": "name" * 70, "b": b"\x00\xff" * 40,
        "list": [1, -200, 70000, -(2 ** 33), 1.25, "x", [None, False]],
        "long_list": list(range(40)), "complex": 1 + 2j})
    return tree


def test_decoder_reads_what_flax_writes(monkeypatch):
    """``to_bytes`` of a tree of every dtype, with arrays above a lowered
    chunk size split as flax splits arrays above 2**30 bytes: the decoder
    returns what ``msgpack_restore`` returns."""
    tree = _every_dtype(np.random.default_rng(0))
    for chunk in (serialization.MAX_CHUNK_SIZE, 16):
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", chunk)
        data = serialization.to_bytes(tree)
        ref = serialization.msgpack_restore(data)
        if chunk == 16:
            assert "__msgpack_chunked_array__" in msgpack.unpackb(
                data, raw=False, strict_map_key=False, ext_hook=lambda c, d: d)["a_float64"]
        _same(flax_msgpack.loads(data), ref)


def test_decoder_reads_every_msgpack_format():
    """``msgpack.packb`` of values in each format (fix and sized ints,
    float32 and float64, str8/16/32, bin, arrays and maps of every size
    class, ext 1 and 3 through flax's packer) decodes to the same values;
    trailing or truncated bytes raise."""
    values = [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32, -33, -128, -129,
              -32768, -32769, -(2 ** 31) - 1, 1e300, "", "a" * 31, "a" * 32, "a" * 256,
              "é" * 40000, b"", b"x" * 300, b"y" * 70000, list(range(15)),
              list(range(16)), list(range(70000)), {str(i): i for i in range(15)},
              {str(i): i for i in range(16)}, {str(i): i for i in range(70000)},
              None, True, False]
    for v in values:
        assert flax_msgpack.loads(msgpack.packb(v, use_bin_type=True)) == v
    assert flax_msgpack.loads(msgpack.packb(1.5, use_single_float=True)) == 1.5
    with pytest.raises(ValueError, match="after"):
        flax_msgpack.loads(msgpack.packb(1) + b"\x01")
    with pytest.raises(ValueError, match="ends"):
        flax_msgpack.loads(msgpack.packb("abcdef")[:-2])


def test_decoder_imports_no_msgpack_flax_or_jax(tmp_path):
    """The port's reader decodes the fixture in a process where
    ``msgpack``, ``flax`` and ``jax`` cannot be imported, as on the card's
    machine."""
    raw = tmp_path / "chkpt_seed0.msgpack"
    raw.write_bytes(lzma.decompress((FIXTURE / "chkpt_seed0.msgpack.xz").read_bytes()))
    script = f"""
import sys
class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("msgpack", "flax", "jax", "jaxlib"):
            raise ImportError(name)
sys.meta_path.insert(0, Refuse())
sys.path.insert(0, {str(REPO)!r})
from gesture_diffusion_torch.interop import flax_msgpack
tree = flax_msgpack.load({str(raw)!r})
assert set(tree) == {{"state", "best_params"}}, set(tree)
print("OK", len(tree["best_params"]["decoder"]))
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0 and "OK" in out.stdout, out.stderr[-2000:]


def test_full_width_checkpoint_loads_bit_equal_and_serves(tmp_path):
    """JAX's ``save_checkpoint`` at beat-ours' full width (d_model 256, 8
    heads, 4 layers, d_pose 123), ``best_params`` apart from the state's
    params: the port reads ``best_params`` with the state's BatchNorm
    statistics bit for bit, and both Generators (ddim10, the scan path)
    give the same sample within 2e-5 on the same noise."""
    config = JaxJsonConfig(str(REPO / "configs" / "beat-ours.json"))
    config.set("Model.Diffusion.timestep_respacing", "ddim10")
    d_pose, window = 123, 40
    bundle = jax_build_all(config, d_pose, is_training=False)
    port_config = JsonConfig(str(REPO / "configs" / "beat-ours.json"))
    port_config.set("Model.Diffusion.timestep_respacing", "ddim10")
    ports = build_all(port_config, d_pose, device="cpu",
                      generator=torch.Generator().manual_seed(1))
    # weights drawn in the port and carried to JAX by its importer: no JAX
    # init runs at full width
    variables = jax.tree.map(np.asarray, import_torch_state_dict(
        ports.model.state_dict(), bundle.model.cfg))
    rng = np.random.default_rng(2)
    state_vars = _perturb(variables, rng)
    best = _perturb(state_vars, rng)["params"]
    state = TrainState(state_vars["params"], state_vars["batch_stats"],
                       init_opt_state(optax.adamw(1e-3), state_vars["params"]),
                       jnp.asarray(10, jnp.int32))
    path = str(tmp_path / "chkpt_seed0.msgpack")
    jax_save(path, {"state": state, "best_params": best}, {"train_step": 10})
    served = jax_checkpoint_state_dict(flax_msgpack.load(path), ports.model.cfg)
    ref = state_dict_from_jax({"params": best, "batch_stats": state_vars["batch_stats"]},
                              ports.model.cfg)
    assert list(served) == list(ref) == list(ports.model.state_dict())
    for k, v in ref.items():
        assert served[k].dtype == v.dtype and torch.equal(served[k], v), k

    wav = np.random.default_rng(3).normal(0, 0.3, (2, 32000)).astype(np.float32)
    noise = np.random.default_rng(4).normal(size=(2, window, d_pose)).astype(np.float32)
    theirs = JaxGenerator(bundle.model, {"params": best,
                                         "batch_stats": state_vars["batch_stats"]},
                          bundle.eval_schedule, bundle.eval_timestep_map,
                          use_fused=False).generate_sample(
        jnp.asarray(wav), d_pose, window, jax.random.key(0), noise=jnp.asarray(noise))
    gen = Generator(ports.model, ports.eval_schedule, ports.eval_timestep_map,
                    use_fused=False, device="cpu")
    gen.update_variables(served)
    ours = gen.generate_sample(torch.from_numpy(wav), d_pose, window,
                               noise=torch.from_numpy(noise))
    assert rel_err(ours, np.asarray(theirs)) < SERVE_TOL


def _fixture_tree():
    return flax_msgpack.loads(lzma.decompress(
        (FIXTURE / "chkpt_seed0.msgpack.xz").read_bytes()))


def test_fixture_serves_as_the_recorded_jax_sample():
    """The committed fixture, read by the port, samples within 2e-5 of the
    JAX Generator's recorded ddim50 sample on the recorded wav and noise
    (what ``chip_smoke.py``'s [jax-chkpt] holds on the card at 1e-4)."""
    config = JsonConfig(str(FIXTURE / "config.json"))
    bundle = build_all(config, 12, device="cpu")
    gen = Generator(bundle.model, bundle.eval_schedule, bundle.eval_timestep_map,
                    use_fused=False, device="cpu")
    gen.update_variables(jax_checkpoint_state_dict(_fixture_tree(), bundle.model.cfg))
    rec = np.load(FIXTURE / "sample.npz")
    ours = gen.generate_sample(torch.from_numpy(rec["wav"]), 12, rec["noise"].shape[1],
                               noise=torch.from_numpy(rec["noise"]))
    assert rel_err(ours, rec["sample"]) < SERVE_TOL


def test_fixture_script_reproduces_the_fixture(tmp_path):
    """``tools/make_jax_chkpt_fixture.py`` still writes the committed
    checkpoint byte for byte, its sidecar and config, and the sample."""
    files = fixture_script.write_fixture(str(tmp_path))
    committed = lzma.decompress((FIXTURE / "chkpt_seed0.msgpack.xz").read_bytes())
    assert files["chkpt_seed0.msgpack"] == committed
    for name in ("chkpt_seed0.msgpack.meta.json", "config.json"):
        assert (tmp_path / name).read_bytes() == (FIXTURE / name).read_bytes(), name
    ours, ref = np.load(tmp_path / "sample.npz"), np.load(FIXTURE / "sample.npz")
    for k in ("wav", "noise"):
        np.testing.assert_array_equal(ours[k], ref[k])
    np.testing.assert_allclose(ours["sample"], ref["sample"], rtol=1e-6, atol=1e-7)


def _fixture_run(tmp: Path) -> str:
    """The fixture's config with its paths under ``tmp`` and the JAX
    checkpoint where the JAX CLI's train phase writes it: the path of
    the config."""
    raw = json.loads((FIXTURE / "config.json").read_text())
    for key in ("spt_dir_path", "dst_dir_path", "hierarchy_path"):
        raw["Data"][key] = str(tmp / raw["Data"][key])
    raw["Meta"]["log_dir"] = str(tmp / raw["Meta"]["log_dir"])
    chkpts = tmp / "log" / raw["Meta"]["name"] / "chkpts"
    chkpts.mkdir(parents=True)
    (chkpts / "chkpt_seed0.msgpack").write_bytes(
        lzma.decompress((FIXTURE / "chkpt_seed0.msgpack.xz").read_bytes()))
    shutil.copy(FIXTURE / "chkpt_seed0.msgpack.meta.json", chkpts)
    with open(raw["Data"]["hierarchy_path"], "w") as f:
        f.write(cli.hierarchy_template(
            str(REPO / "tests" / "golden" / "synth_fullbody.bvh"),
            raw["Data"]["joints"], raw["Data"]["hierarchy_extra_joints"]))
    path = tmp / "config.json"
    path.write_text(json.dumps(raw))
    return str(path)


def test_cli_serves_a_jax_checkpoint(tmp_path, capsys):
    """With only the JAX CLI's ``chkpt_seed0.msgpack`` in the run (no
    ``.pt``), eval-time and gen serve it through the fused path: finite
    samples of every test sequence; ``load_eval_objs`` serves
    ``best_params`` with the state's BatchNorm statistics."""
    cfg = _fixture_run(tmp_path)
    for phase in ("prep", "data", "eval-time", "gen"):
        cli.main(["--phase", phase, "--config", cfg, "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "Load the JAX package's chkpt" in printed and "path=fused" in printed
    samples = tmp_path / "log" / "jax_chkpt" / "results" / "samples"
    assert len(os.listdir(samples)) == 2
    config = JsonConfig(cfg)
    config.set("Meta.seed", 0)
    meta, _, generator = cli.load_eval_objs(config, device="cpu")
    assert meta["train_step"] == 4
    tree = _fixture_tree()
    ref = state_dict_from_jax({"params": tree["best_params"],
                               "batch_stats": tree["state"]["batch_stats"]},
                              generator.model.cfg)
    for k, v in generator.model.state_dict().items():
        assert torch.equal(v, ref[k]), k


def test_start_chkpt_reads_jax_best_params(tmp_path):
    """``Model.start_chkpt`` naming a JAX ``.msgpack``: every parameter is
    its ``best_params`` (as JAX's ``load_start_params`` reads it), and the
    BatchNorm statistics keep their fresh values, which ``params`` does not
    hold."""
    raw = tmp_path / "start.msgpack"
    raw.write_bytes(lzma.decompress((FIXTURE / "chkpt_seed0.msgpack.xz").read_bytes()))
    bundle = build_all(JsonConfig(str(FIXTURE / "config.json")), 12, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in bundle.model.named_buffers()}
    loaded = load_start_params(bundle.model, str(raw))
    params = jax_params_state_dict(_fixture_tree()["best_params"], bundle.model.cfg)
    assert loaded == len(params) == len(list(bundle.model.parameters()))
    for k, p in bundle.model.named_parameters():
        assert torch.equal(p.detach(), params[k]), k
    for k, v in bundle.model.named_buffers():
        assert torch.equal(v, before[k]), k
