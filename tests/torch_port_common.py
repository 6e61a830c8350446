"""Shared setup of the port's parity tests (tests/test_torch_port_*.py).

Both sides run in float32 on the CPU (tests/conftest.py pins JAX matmuls
to "highest").  Inputs come from numpy with a seed; weights are built by
the JAX package, moved off their init values (biases, LayerNorm/BN affine,
BN running statistics), and carried into the port with
``state_dict_from_jax``.  The inpaint model type's conditioning MLP starts
at zero in both packages; here its kernels are redrawn from the seed, so
that what it adds is visible to every comparison.  ``write_toy_recording``
writes one recording of a toy BEAT corpus (BVH, wav, TextGrid, facial
JSON) for the prep and export tests.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gesture_diffusion_tpu.models import DenoiserConfig as JaxConfig
from gesture_diffusion_tpu.models import GestureDenoiser as JaxDenoiser
from gesture_diffusion_torch.interop import state_dict_from_jax
from gesture_diffusion_torch.models import DenoiserConfig, GestureDenoiser

# the suite runs under xdist -n 6: one torch thread per worker
torch.set_num_threads(1)

D_POSE, T, DM, HEADS = 12, 8, 256, 8


def seeded_wav(seed: int, n: int = 2, length: int = 8000) -> np.ndarray:
    return np.random.default_rng(seed).normal(0, 0.3, (n, length)).astype(np.float32)


def _perturb(tree, rng):
    """Biases and affine scales off their (0, 1) init; kernels untouched."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng)
        elif k in ("bias", "mean"):
            out[k] = v + rng.normal(0, 0.05, v.shape).astype(np.float32)
        elif k in ("scale", "var"):
            out[k] = v * rng.uniform(0.8, 1.2, v.shape).astype(np.float32)
        else:
            out[k] = v
    return out


def _redraw_zero_kernels(tree, rng):
    """Every all-zero kernel (the UNet's zero-initialised output convs and
    projections) redrawn at 1/sqrt(fan_in), so that what it carries is
    visible to every comparison."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _redraw_zero_kernels(v, rng)
        elif k == "kernel" and not np.abs(v).max():
            fan_in = int(np.prod(v.shape[:-1]))
            tree[k] = rng.normal(0, fan_in ** -0.5, v.shape).astype(np.float32)


def jax_variables(model_type: str = "s2g_v2", n_layers: int = 1,
                  wav: "np.ndarray | None" = None, seed: int = 0,
                  d_model: int = DM, heads: int = HEADS, t: int = T,
                  d_pose: int = D_POSE, **cfg_kw):
    """(JAX config, numpy variables) of a small denoiser; ``cfg_kw`` goes
    to the JAX ``DenoiserConfig`` (e.g. ``pose_seed_len``,
    ``encoder_dtype``, ``decoder_type`` and its extras)."""
    cfg = JaxConfig(d_pose=d_pose, d_model=d_model, heads=heads,
                    n_layers=n_layers, model_type=model_type, **cfg_kw)
    wav = seeded_wav(seed) if wav is None else wav
    n = wav.shape[0]
    extra = {}
    if model_type == "inpaint":
        extra = dict(inpaint_pose=jnp.zeros((n, t, d_pose)),
                     inpaint_mask=jnp.zeros((n, t, 1)))
    variables = JaxDenoiser(cfg).init(
        jax.random.key(seed), jnp.zeros((n, t, d_pose)),
        jnp.zeros((n,), jnp.int32), jnp.asarray(wav), train=False, **extra)
    variables = jax.tree.map(np.asarray, variables)
    rng = np.random.default_rng(seed + 100)
    if model_type == "inpaint":
        proj = variables["params"]["inpaint_proj"]
        for layer in proj.values():
            fan_in = layer["kernel"].shape[0]
            layer["kernel"] = rng.normal(
                0, fan_in ** -0.5, layer["kernel"].shape).astype(np.float32)
        assert all(np.abs(l["kernel"]).max() > 0 for l in proj.values())
    if cfg.decoder_type == "unet_attention":
        _redraw_zero_kernels(variables["params"]["decoder"], rng)
    return cfg, _perturb(variables, rng)


def inpaint_tensors(seed: int, n: int = 2, t: int = T, seed_len: int = 2):
    """(poses (N, T, D_POSE), mask (N, T, 1)) with the first ``seed_len``
    frames marked as seed frames."""
    poses = np.random.default_rng(seed).normal(size=(n, t, D_POSE)).astype(np.float32)
    mask = np.zeros((n, t, 1), np.float32)
    mask[:, :seed_len] = 1.0
    return poses, mask


def port_model(cfg, variables) -> GestureDenoiser:
    """The port's denoiser on the same weights (strict load)."""
    model = GestureDenoiser(DenoiserConfig(
        d_pose=cfg.d_pose, d_model=cfg.d_model, heads=cfg.heads,
        n_layers=cfg.n_layers, model_type=cfg.model_type,
        dropout=cfg.dropout, pose_seed_len=cfg.pose_seed_len,
        encoder_dtype=cfg.encoder_dtype, decoder_type=cfg.decoder_type,
        graph_layout=cfg.graph_layout, graph_strategy=cfg.graph_strategy,
        channel_mult=tuple(cfg.channel_mult),
        attention_resolutions=tuple(cfg.attention_resolutions),
        window_len=cfg.window_len))
    model.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    return model.eval()


def rel_err(ours, ref) -> float:
    """max |ours - ref| / max |ref|."""
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-30))


# -- a toy BEAT corpus ---------------------------------------------------------

TOY_BVH_HEADER = (
    "HIERARCHY\nROOT Hips\n{\n"
    "\tOFFSET 0 0 0\n"
    "\tCHANNELS 6 Xposition Yposition Zposition Xrotation Yrotation Zrotation\n"
    "\tJOINT Spine\n\t{\n\t\tOFFSET 0 2 0\n"
    "\t\tCHANNELS 3 Xrotation Yrotation Zrotation\n"
    "\t\tEnd Site\n\t\t{\n\t\t\tOFFSET 0 1 0\n\t\t}\n\t}\n}\n")


def textgrid_text(words, seconds: float) -> str:
    """A long-format Praat TextGrid with one word tier: ``words`` as
    (xmin, xmax, mark), the gaps between them as empty intervals."""
    ivs, t = [], 0.0
    for xmin, xmax, mark in words:
        if xmin > t:
            ivs.append((t, xmin, ""))
        ivs.append((xmin, xmax, mark))
        t = xmax
    if t < seconds:
        ivs.append((t, seconds, ""))
    body = "".join(
        f"        intervals [{i + 1}]:\n            xmin = {a}\n"
        f"            xmax = {b}\n            text = \"{m}\"\n"
        for i, (a, b, m) in enumerate(ivs))
    return ('File type = "ooTextFile"\nObject class = "TextGrid"\n\n'
            f"xmin = 0\nxmax = {seconds}\ntiers? <exists>\nsize = 1\nitem []:\n"
            '    item [1]:\n        class = "IntervalTier"\n        name = "words"\n'
            f"        xmin = 0\n        xmax = {seconds}\n"
            f"        intervals: size = {len(ivs)}\n" + body)


def write_toy_recording(directory, name: str, seed: int, seconds: int = 30,
                        wav_sr: int = 8000, textgrid: bool = True,
                        face: bool = False) -> None:
    """``{name}.bvh`` (the 2-joint toy skeleton at 120 fps, seeded values
    printed as %.4f), ``{name}.wav`` (int16 at ``wav_sr``), and unless
    told otherwise ``{name}.TextGrid`` (seeded words, some before the 5 s
    sync) and ``{name}.json`` (BEAT facial weights at 60 fps)."""
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    base = os.path.join(str(directory), name)
    n = seconds * 120
    vals = rng.uniform(-30, 30, (n, 9))
    with open(base + ".bvh", "w") as f:
        f.write(TOY_BVH_HEADER + f"MOTION\nFrames: {n}\nFrame Time: 0.008333\n")
        f.write("".join(" ".join(f"{v:.4f}" for v in row) + "\n" for row in vals))
    wav = (rng.normal(0, 0.1, seconds * wav_sr) * 32767 * 0.2).astype(np.int16)
    wavfile.write(base + ".wav", wav_sr, wav)
    if textgrid:
        vocab = ["hello", "world", "gesture", f"word{seed}", "beat"]
        starts = np.sort(rng.uniform(0.5, seconds - 2.0, 8))
        words = [(round(float(s), 3), round(float(s) + 0.4, 3), vocab[i % 5])
                 for i, s in enumerate(starts)]
        with open(base + ".TextGrid", "w") as f:
            f.write(textgrid_text(words, float(seconds)))
    if face:
        frames = [{"weights": rng.uniform(0, 1, 4).round(4).tolist()}
                  for _ in range(seconds * 60)]
        with open(base + ".json", "w") as f:
            json.dump({"frames": frames}, f)
