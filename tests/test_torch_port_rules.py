"""Rules of the port package: it imports neither JAX nor the JAX package,
its entry points refuse to drop to the CPU silently, and chip_smoke.py
refuses to report without a card."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "gesture_diffusion_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "gesture_diffusion_tpu")

torch.set_num_threads(1)


def _modules():
    return sorted(PKG.rglob("*.py"))


@pytest.mark.parametrize("path", _modules(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_imports_with_jax_blocked():
    """Every module of the package imports in a process where jax and the
    JAX package cannot be imported."""
    mods = [".".join(p.relative_to(REPO).with_suffix("").parts)
            for p in _modules()]
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m for m in mods]
    code = ("import sys\n"
            + "".join(f"sys.modules[{m!r}] = None\n" for m in FORBIDDEN)
            + "import importlib\n"
            + "".join(f"importlib.import_module({m!r})\n" for m in mods)
            + "assert not any(k.split('.')[0] in %r and sys.modules[k] is not None "
              "for k in sys.modules)\n" % (FORBIDDEN,))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_package_imports_without_optional_libraries():
    """``import gesture_diffusion_torch`` and every module of it, then the
    mocap transforms and the HTML player on the CPU, in a process where a
    meta-path finder refuses JAX, the JAX package, sklearn, matplotlib,
    Pillow and IPython (the card's machine has none of the first five): the
    stick figures and ``nb_play_mocap`` import theirs only when called.
    (A None in sys.modules would not do: scipy looks jax up there.)"""
    blocked = FORBIDDEN + ("sklearn", "matplotlib", "PIL", "IPython")
    mods = [".".join(p.relative_to(REPO).with_suffix("").parts)
            for p in _modules()]
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m for m in mods]
    bvh = str(REPO / "tests" / "golden" / "toy_chain.bvh")
    code = ("import sys, importlib\n"
            "class Absent:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            f"        if name.split('.')[0] in {blocked!r}:\n"
            "            raise ModuleNotFoundError(name)\n"
            "sys.meta_path.insert(0, Absent())\n"
            "import gesture_diffusion_torch\n"
            + "".join(f"importlib.import_module({m!r})\n" for m in mods)
            + "from gesture_diffusion_torch.data import mocap_transforms as mt, parse_bvh\n"
            "from gesture_diffusion_torch.export import render_mocap_player_html\n"
            f"track = parse_bvh({bvh!r})\n"
            "pos = mt.MocapParameterizer('position', device='cpu').transform([track])\n"
            "rt = mt.RootTransformer('pos_rot_deltas', 5, 2, device='cpu')\n"
            "rt.inverse_transform(rt.transform([track]))\n"
            "assert 'Charlie_Nub' in render_mocap_player_html(pos[0])\n"
            f"assert not any(k.split('.')[0] in {blocked!r} for k in sys.modules)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    from gesture_diffusion_torch.diffusion import make_diffusion
    from gesture_diffusion_torch.generation import Generator
    from gesture_diffusion_torch.models import DenoiserConfig, GestureDenoiser, build_model
    from gesture_diffusion_torch.utils import JsonConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = JsonConfig(str(REPO / "configs" / "beat-ours.json"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(123, cfg.Model)
    model = GestureDenoiser(DenoiserConfig(d_pose=12, n_layers=1))
    sched, tmap = make_diffusion("linear", 100, "ddim10")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Generator(model, sched, tmap)
    gen = Generator(model, sched, tmap, device="cpu")
    assert gen.device.type == "cpu" and gen.use_fused
    # the phase CLI: without --device cpu it raises before any phase runs
    from gesture_diffusion_torch import cli

    ran = []
    monkeypatch.setitem(cli.PHASES, "data", lambda config, device: ran.append(device))
    argv = ["--phase", "data", "--config", str(REPO / "configs" / "beat-ours.json")]
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(argv)
    assert not ran
    cli.main(argv + ["--device", "cpu"])
    assert ran == [torch.device("cpu")]
    # the mocap transforms that do rotation math
    from gesture_diffusion_torch.data import mocap_transforms as mt

    with pytest.raises(RuntimeError, match="device='cpu'"):
        mt.RootTransformer("pos_rot_deltas")
    assert mt.RootTransformer("pos_rot_deltas", device="cpu").device.type == "cpu"


def test_trainer_refuses_cpu_fallback(monkeypatch, tmp_path):
    """The Trainer runs on the card unless the caller asks for the CPU."""
    import numpy as np

    from gesture_diffusion_torch.diffusion import make_diffusion
    from gesture_diffusion_torch.models import DenoiserConfig, GestureDenoiser
    from gesture_diffusion_torch.training import make_adamw
    from gesture_diffusion_torch.training import ArrayDataset, Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = GestureDenoiser(DenoiserConfig(d_pose=12, d_model=32, heads=4, n_layers=1))
    sched, _ = make_diffusion("linear", 50, "")
    data = ArrayDataset({"wav": np.zeros((4, 8000), np.float32),
                         "pose": np.zeros((4, 10, 12), np.float32)})
    args = (model, sched, make_adamw(model.parameters(), 1e-3, 0.0), lambda s: 1e-3,
            data, data, 2, str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(*args)
    assert not (tmp_path / "chkpts").exists()
    assert Trainer(*args, device="cpu").device.type == "cpu"


def test_build_model_rejects_unported_decoders():
    """Every decoder the JAX factory builds is ported: tedexp's 10-layer
    cross-attention decoder builds at its widths; a type the JAX factory
    does not build still raises."""
    from gesture_diffusion_torch.models import build_model
    from gesture_diffusion_torch.models.decoders import CrossAttention
    from gesture_diffusion_torch.utils import JsonConfig

    cfg = JsonConfig(str(REPO / "configs" / "tedexp-ours.json"))
    model = build_model(126, cfg.Model, device="cpu")
    assert isinstance(model.pose_decoder, CrossAttention)
    assert len(model.pose_decoder.layers) == 10 and model.cfg.d_model == 512
    assert not hasattr(model.pose_decoder.layers[9], "feed_forward_mem")
    cfg.set("Model.Decoder.type", "transformer")
    with pytest.raises(ValueError, match="Unsupported decoder"):
        build_model(126, cfg.Model, device="cpu")


def test_beat_config_builds_flagship_on_cpu():
    from gesture_diffusion_torch.models import build_all
    from gesture_diffusion_torch.utils import JsonConfig

    b = build_all(JsonConfig(str(REPO / "configs" / "beat-ours.json")), 123,
                  device="cpu", generator=torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in b.model.parameters()) == 10_340_087
    assert b.eval_schedule.num_timesteps == 1000
    assert not b.model.training


def test_chip_smoke_refuses_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py runs for real there")
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    # alone in a directory, without the package, it fails too
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((REPO / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, str(lone)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
