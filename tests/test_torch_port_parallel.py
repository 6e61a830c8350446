"""Data parallelism of the port against the JAX package, on the CPU.

The mesh and its errors, the per-process batch split, the sampler's
ragged gather, global BatchNorm, one DDP train step and the CLI's
``Train.world_size`` run over two gloo processes on this host, spawned
as subprocesses with a timeout (there is no pytest-timeout plugin);
the sharded Generator runs over ``make_mesh(devices=["cpu", "cpu"])``
through the kernel's plain version.  Widths as in
``test_torch_port_training.py``: d_pose 12, d_model 32, 4 heads, 1 layer,
8000-sample wav, T 10, 50 diffusion steps, a global batch of 4.
"""

import json
import os
import signal
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gesture_diffusion_tpu.diffusion import make_diffusion as jax_make
from gesture_diffusion_tpu.diffusion import make_schedule as jax_make_schedule
from gesture_diffusion_tpu.diffusion.resample import \
    LossSecondMomentResampler as JaxLossSampler
from gesture_diffusion_tpu.generation import Generator as JaxGenerator
from gesture_diffusion_tpu.models import GestureDenoiser as JaxDenoiser
from gesture_diffusion_tpu.parallel import make_mesh as jax_make_mesh
from gesture_diffusion_tpu.parallel import replicate as jax_replicate
from gesture_diffusion_tpu.parallel import shard_batch as jax_shard_batch
from gesture_diffusion_tpu.training import data as jax_data
from gesture_diffusion_tpu.training.train_state import assemble_losses as jax_assemble
from gesture_diffusion_torch import cli
from gesture_diffusion_torch.diffusion import make_diffusion, make_schedule
from gesture_diffusion_torch.diffusion.resample import LossSecondMomentResampler
from gesture_diffusion_torch.generation import Generator
from gesture_diffusion_torch.generation import generator as generator_module
from gesture_diffusion_torch.generation.generator import check_data_mesh
from gesture_diffusion_torch.interop import state_dict_from_jax
from gesture_diffusion_torch.models import DenoiserConfig, GestureDenoiser, init_random_
from gesture_diffusion_torch.models.speech_encoder import BatchNorm2d
from gesture_diffusion_torch.ops import fused_sampler as fs
from gesture_diffusion_torch.parallel import active_group, make_mesh, replicate, split_batch
from gesture_diffusion_torch.training import (ArrayDataset, iter_batches,
                                              make_adamw, make_train_step)
from gesture_diffusion_torch.utils.profiling import time_fn, trace
from torch_port_common import D_POSE, jax_variables, port_model, rel_err, seeded_wav

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
STEPS, N, TW, DMS, HS, WAV = 50, 4, 10, 32, 4, 8000
# the bars of test_torch_port_training.py: losses and BN statistics 1e-5 of
# the reference, the float32 norm 1e-3, each gradient outside the SE-ResNet
# trunk 1e-4 of its max|g| (floor 1e-2 of the largest), the trunk's
# float32 gradient being ill-conditioned on random weights (that file)
TOL, GRAD_TOL, NORM_TOL_F32 = 1e-5, 1e-4, 1e-3
# one process against two in float64: sums in other orders only
F64_TOL = 1e-9
LOSS_PARAMS = {"speed_loss": 0.1, "speed_l1_loss": 0.2,
               "speed_constraint_loss": 0.05}
TRUNK = "speech_encoder.wav_encoder.feat_extractor."
SPAWN_TIMEOUT = 240
# the bf16 encoder: a gradient group's |d|/|ref| cap and the band of its
# norm against float64's (test_torch_port_bf16_grads.py's L2_CAP, NORM_BAND)
BF16_CAP, BF16_NORM_BAND = 0.8, (0.8, 1.25)


def _betas():
    from gesture_diffusion_tpu.diffusion import linear_betas

    return np.asarray(linear_betas(STEPS))


# -- the mesh ------------------------------------------------------------------

@pytest.mark.parametrize("n_data,n_model,n_dev", [
    (None, 1, 2), (2, 1, 3), (3, 1, 2), (None, 3, 8), (8, 2, 8), (4, 2, 8),
    (None, 2, 8)])
def test_make_mesh_errors_match_jax(n_data, n_model, n_dev):
    """The same cases raise with the same message, and the others build
    the JAX mesh's shape, a model axis included (outside a process group
    it makes no axes: ``tests/test_torch_port_tp.py`` makes them)."""
    try:
        ref = jax_make_mesh(n_data, n_model, jax.devices()[:n_dev])
    except ValueError as e:
        with pytest.raises(ValueError) as ours:
            make_mesh(n_data, n_model, ["cpu"] * n_dev)
        assert str(ours.value) == str(e)
        return
    mesh = make_mesh(n_data, n_model, ["cpu"] * n_dev)
    assert mesh.shape == dict(ref.shape)
    assert mesh.devices == (torch.device("cpu"),) * ref.devices.size


def test_make_mesh_defaults_to_the_gpus(monkeypatch):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert make_mesh().devices == (torch.device("cuda", 0),)
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices, have 1"):
        make_mesh(n_data=2)
    # the CLI's train on a one-GPU machine: Train.world_size 2 raises this
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices, have 1"):
        cli.train_mesh(2, torch.device("cuda"))
    assert cli.train_mesh(2, torch.device("cpu")).shape["data"] == 2


def test_split_batch_and_replicate():
    mesh = make_mesh(devices=["cpu", "cpu"])
    batch = {"pose": torch.arange(24.0).view(4, 3, 2), "mask": None,
             "wav": (torch.ones(4, 5), torch.zeros(4))}
    pieces = split_batch(batch, mesh)
    assert len(pieces) == 2 and pieces[1]["mask"] is None
    assert torch.equal(torch.cat([p["pose"] for p in pieces]), batch["pose"])
    assert pieces[0]["wav"][0].shape == (2, 5)
    with pytest.raises(ValueError, match="not divisible"):
        split_batch(torch.zeros(3, 1), mesh)
    with pytest.raises(ValueError, match="disagree"):
        split_batch({"a": torch.zeros(4), "b": torch.zeros(2)}, mesh)
    tree = {"w": torch.ones(2, 2)}
    copies = replicate(tree, mesh)
    # a device that repeats shares one copy
    assert len(copies) == 2 and copies[0] is copies[1]
    pack = fs.PackedDenoiser(*[torch.full((1,), float(i))
                               for i in range(len(fs.PackedDenoiser._fields))])
    copies = replicate((pack, None), mesh)
    first = copies[0][0]
    # a NamedTuple stays one, and a tensor already on the device is not copied
    assert copies[0] is copies[1] and copies[0][1] is None
    assert type(first) is fs.PackedDenoiser and first.b_out is pack.b_out


# -- the per-process batch split ----------------------------------------------

@pytest.mark.parametrize("n,batch_size,count,drop_last", [
    (23, 8, 2, True), (23, 8, 4, True), (22, 16, 4, False), (21, 6, 3, False),
    (18, 4, 2, False), (24, 12, 1, True)])
def test_iter_batches_per_rank_match_jax(n, batch_size, count, drop_last):
    """Each rank's rows are the rows the JAX package gives process r of
    ``count``, ragged final batches included (cut to divide, as JAX's)."""
    rng = np.random.default_rng(n)
    data = {"wav": rng.normal(size=(n, 6)).astype(np.float32),
            "pose": rng.normal(size=(n, 3, 2)).astype(np.float32)}
    for rank in range(count):
        ours = list(iter_batches(ArrayDataset(data), batch_size,
                                 rng=np.random.default_rng(5), drop_last=drop_last,
                                 process_index=rank, process_count=count))
        ref = list(jax_data.iter_batches(
            jax_data.ArrayDataset(data), batch_size, rng=np.random.default_rng(5),
            drop_last=drop_last, process_index=rank, process_count=count))
        assert len(ours) == len(ref)
        for a, b in zip(ours, ref):
            for k in data:
                np.testing.assert_array_equal(a[k], np.asarray(b[k]))


@pytest.mark.parametrize("count", [5, 7])
def test_indivisible_batch_is_the_jax_error(count):
    """A global batch that does not divide over the processes raises the
    JAX package's error."""
    ds = {"pose": np.zeros((24, 1, 2), np.float32), "wav": np.zeros((24, 8), np.float32)}
    kw = dict(shuffle=False, process_index=0, process_count=count)
    with pytest.raises(ValueError) as ref:
        list(jax_data.iter_batches(jax_data.ArrayDataset(ds), 12, **kw))
    with pytest.raises(ValueError) as ours:
        list(iter_batches(ArrayDataset(ds), 12, **kw))
    assert str(ours.value) == str(ref.value)


# -- DDP: every parameter gets a gradient ------------------------------------

DECODERS = {
    "oneway_cross_attention": {},
    "cross_attention": {},
    "cross_attention_gcn": dict(d_pose=150, d_model=75, heads=3),
    "unet_attention": dict(channel_mult=(1, 2), attention_resolutions=(1, 2),
                           window_len=10),
}


@pytest.mark.parametrize("model_type", ["s2g_v2", "default", "inpaint"])
@pytest.mark.parametrize("decoder", list(DECODERS))
def test_every_parameter_gets_a_gradient(decoder, model_type):
    """Why the DDP wrapper keeps ``find_unused_parameters=False``: one
    forward and backward reaches every parameter of every decoder and
    model type (DDP raises on a parameter that gets no gradient)."""
    kw = dict(d_pose=D_POSE, d_model=DMS, heads=HS, n_layers=1)
    kw.update(DECODERS[decoder])
    cfg = DenoiserConfig(model_type=model_type, decoder_type=decoder,
                         pose_seed_len=4, **kw)
    model = GestureDenoiser(cfg).train()
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, TW, cfg.d_pose, generator=g)
    extra = {}
    if model_type == "inpaint":
        extra = dict(inpaint_pose=torch.randn(2, TW, cfg.d_pose, generator=g),
                     inpaint_mask=torch.ones(2, TW, 1))
    wav = torch.from_numpy(seeded_wav(3, n=2))
    model(x, torch.tensor([1, 30]), wav, **extra).square().sum().backward()
    assert [k for k, p in model.named_parameters() if p.grad is None] == []


# -- two gloo processes ----------------------------------------------------------

_WORKER = r"""
import sys
rank, port, work = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.path.insert(0, %(repo)r)
import numpy as np
import torch
torch.set_num_threads(1)
from gesture_diffusion_torch.diffusion import make_schedule
from gesture_diffusion_torch.diffusion.resample import LossSecondMomentResampler
from gesture_diffusion_torch.models import DenoiserConfig, GestureDenoiser, init_random_
from gesture_diffusion_torch.models.speech_encoder import BatchNorm2d
from gesture_diffusion_torch.parallel import init_distributed
from gesture_diffusion_torch.training import make_adamw, make_train_step

assert init_distributed(f"localhost:{port}", 2, rank) == rank
inp = torch.load(f"{work}/inputs.pt", weights_only=True)
out = {}

# 1. the sampler's history through the ragged gather: 3 + 1 pairs, then
# 2 + 0
s = LossSecondMomentResampler(4, history_per_term=2)
for ts, losses in inp["hist"][rank]:
    s.update_with_local_losses(ts.numpy(), losses.numpy())
out["hist"] = torch.from_numpy(s._loss_history.copy())
out["counts"] = torch.from_numpy(s._loss_counts.copy())

# 2. global BatchNorm on this rank's rows, float32 and (with the
# gradient) float64
for dtype in (torch.float32, torch.float64):
    bn = BatchNorm2d(5).to(dtype).train()
    bn.load_state_dict({k: v.to(dtype) if v.is_floating_point() else v
                        for k, v in inp["bn_state"].items()})
    x = inp["bn_x"].to(dtype)[2 * rank:2 * rank + 2].clone().requires_grad_()
    y = bn(x)
    (y * inp["bn_g"].to(dtype)[2 * rank:2 * rank + 2]).sum().backward()
    tag = str(dtype).split(".")[-1]
    out[f"bn_{tag}"] = {"y": y.detach(), "x_grad": x.grad,
                        "w_grad": bn.weight.grad, "b_grad": bn.bias.grad,
                        "mean": bn.running_mean, "var": bn.running_var}

# 3. one DDP train step per case on this rank's rows of the global batch
sched = make_schedule(inp["betas"].numpy())
for name, case in inp["steps"].items():
    dtype = getattr(torch, case["dtype"])
    model = GestureDenoiser(DenoiserConfig(**case["cfg"])).to(dtype)
    model.load_state_dict(case["state"])
    step = make_train_step(model, sched, make_adamw(model.parameters(), case["lr"], 0.0),
                           lambda k: case["lr"], case["loss_params"])
    rows = slice(2 * rank, 2 * rank + 2)
    batch = {"pose": case["pose"][rows].to(dtype), "wav": case["wav"][rows]}
    metrics = step(batch, 0, t=case["t"], noise=case["noise"].to(dtype))
    out[name] = {"metrics": {k: float(v) for k, v in metrics.items()},
                 "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
                 "state": {k: v.clone() for k, v in model.state_dict().items()}}
torch.save(out, f"{work}/out_{rank}.pt")
print("DONE", rank, flush=True)
"""


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _run(argv, timeout=SPAWN_TIMEOUT, threads=2, **kw):
    """A subprocess in its own session with ``threads`` OpenMP threads
    (the CLI's spawned ranks share them), killed with its children on
    expiry: (returncode, stdout, stderr)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = str(threads)
    proc = subprocess.Popen(argv, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True, **kw)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        pytest.fail(f"{argv[:4]} timed out after {timeout} s:\n{err[-3000:]}")
    return proc.returncode, out, err


def _jax_draws(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, STEPS, shape[0]).astype(np.int64),
            rng.normal(size=shape))


def _jax_mesh_step(cfg, variables, batch, t, noise):
    """The JAX step's losses, gradients and BN statistics with the batch
    sharded over a 2-device ``data`` mesh of the conftest's virtual CPU
    devices (XLA inserts the collectives)."""
    model = JaxDenoiser(cfg)
    sched = jax_make_schedule(_betas())
    mesh = jax_make_mesh(n_data=2)
    data = jax_shard_batch({"pose": batch["pose"], "wav": batch["wav"],
                            "t": t.astype(np.int32),
                            "noise": noise.astype(np.float32)}, mesh)
    assert len(data["pose"].sharding.device_set) == 2
    params, stats = jax_replicate((variables["params"], variables["batch_stats"]), mesh)

    @jax.jit
    def run(params, stats, data):
        def loss_fn(params):
            mutated = {}

            def model_fn(x_t, tt):
                out, mut = model.apply(
                    {"params": params, "batch_stats": stats}, x_t, tt, data["wav"],
                    train=True, mutable=["batch_stats"],
                    rngs={"dropout": jax.random.key(0)})
                mutated["stats"] = mut["batch_stats"]
                return out

            losses = jax_assemble(sched, model_fn, data["pose"], data["t"],
                                  data["noise"], LOSS_PARAMS)
            return losses["loss"], (losses, mutated["stats"])

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    (_, (losses, new_stats)), grads = run(params, stats, data)
    return jax.tree.map(np.asarray, (losses, grads, new_stats))


def _single_step(case):
    """The port's one-process step on the global batch."""
    dtype = getattr(torch, case["dtype"])
    model = GestureDenoiser(DenoiserConfig(**case["cfg"])).to(dtype)
    model.load_state_dict(case["state"])
    step = make_train_step(model, make_schedule(_betas()),
                           make_adamw(model.parameters(), case["lr"], 0.0),
                           lambda k: case["lr"], case["loss_params"])
    metrics = step({"pose": case["pose"].to(dtype), "wav": case["wav"]}, 0,
                   t=case["t"], noise=case["noise"].to(dtype))
    return ({k: float(v) for k, v in metrics.items()},
            {k: p.grad for k, p in model.named_parameters()}, model.state_dict())


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Inputs, the two gloo ranks' results, and the JAX references."""
    work = tmp_path_factory.mktemp("ddp")
    rng = np.random.default_rng(8)
    hist = [[(rng.integers(0, 4, k), rng.gamma(2.0, 1.0, k).astype(np.float32))
             for k in ks] for ks in ((3, 2), (1, 0))]
    bn_x = rng.normal(1.0, 2.0, (4, 5, 4, 6))
    bn_g = rng.normal(size=(4, 5, 4, 6))
    bn_state = {"weight": torch.from_numpy(rng.uniform(0.5, 1.5, 5)),
                "bias": torch.from_numpy(rng.normal(size=5)),
                "running_mean": torch.from_numpy(rng.normal(size=5)),
                "running_var": torch.from_numpy(rng.uniform(0.5, 2.0, 5)),
                "num_batches_tracked": torch.tensor(0)}
    bn_state = {k: v.float() if v.is_floating_point() else v for k, v in bn_state.items()}
    steps, jax_refs = {}, {}
    wav = seeded_wav(11, n=N, length=WAV)
    pose = 0.5 * np.random.default_rng(12).normal(size=(N, TW, D_POSE))
    t, noise = _jax_draws((N, TW, D_POSE), 13)
    for model_type, dtype, lr, enc in (("s2g_v2", "float32", 0.0, None),
                                       ("s2g_v2", "float32", 0.0, "bfloat16"),
                                       ("s2g_v2", "float64", 1e-3, None),
                                       ("inpaint", "float64", 1e-3, None)):
        name = f"{model_type}_{enc or dtype}"
        cfg = dict(d_pose=D_POSE, d_model=DMS, heads=HS, n_layers=1,
                   model_type=model_type, pose_seed_len=4, encoder_dtype=enc)
        if dtype == "float32":
            jax_cfg, variables = jax_variables(model_type, n_layers=1, wav=wav,
                                               seed=5, d_model=DMS, heads=HS, t=TW,
                                               pose_seed_len=4, encoder_dtype=enc)
            state = port_model(jax_cfg, variables).state_dict()
            jax_refs[name] = (jax_cfg, _jax_mesh_step(
                jax_cfg, variables, {"pose": pose.astype(np.float32), "wav": wav},
                t, noise))
        else:
            # the one-process reference is the port's own step: seeded weights
            state = init_random_(GestureDenoiser(DenoiserConfig(**cfg)),
                                 torch.Generator().manual_seed(14)).state_dict()
        tdtype = getattr(torch, dtype)
        steps[name] = {
            "cfg": cfg, "dtype": dtype, "lr": lr, "loss_params": LOSS_PARAMS,
            "state": state, "pose": torch.from_numpy(pose).to(tdtype),
            "wav": torch.from_numpy(wav), "t": torch.from_numpy(t),
            "noise": torch.from_numpy(noise).to(tdtype)}
    torch.save({"hist": [[(torch.from_numpy(a), torch.from_numpy(b)) for a, b in h]
                         for h in hist],
                "bn_x": torch.from_numpy(bn_x), "bn_g": torch.from_numpy(bn_g),
                "bn_state": bn_state, "betas": torch.from_numpy(_betas()),
                "steps": steps}, work / "inputs.pt")
    port = _free_port()
    script = _WORKER % {"repo": str(REPO)}
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r), str(port), str(work)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              start_new_session=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT))
    except subprocess.TimeoutExpired:
        for p in procs:
            os.killpg(p.pid, signal.SIGKILL)
        pytest.fail("the two gloo ranks did not finish in time")
    for p, (out, err) in zip(procs, logs):
        assert p.returncode == 0 and "DONE" in out, err[-3000:]
    outs = [torch.load(work / f"out_{r}.pt", weights_only=True) for r in range(2)]
    return {"hist": hist, "bn": (bn_x, bn_g, bn_state), "steps": steps,
            "jax": jax_refs, "outs": outs}


def test_gather_keeps_histories_equal(two_ranks):
    """Ragged lengths (3 + 1 pairs, then 2 + 0): both ranks' histories are
    bit-equal, and equal to the update on the concatenation, for the port
    and for the JAX package's sampler with the same gather injected."""
    a, b = two_ranks["outs"]
    assert torch.equal(a["hist"], b["hist"]) and torch.equal(a["counts"], b["counts"])
    ours, ref = LossSecondMomentResampler(4, history_per_term=2), JaxLossSampler(4, history_per_term=2)
    hist = two_ranks["hist"]
    for step in range(2):
        ts = np.concatenate([hist[r][step][0] for r in range(2)])
        losses = np.concatenate([hist[r][step][1] for r in range(2)])
        ours.update_with_all_losses(ts, losses)
        ref.update_with_local_losses(hist[0][step][0], hist[0][step][1],
                                     allgather=lambda x, s=step: [
                                         np.stack([hist[r][s][0].astype(np.float64),
                                                   hist[r][s][1].astype(np.float64)], 1)
                                         for r in range(2)])
    np.testing.assert_array_equal(a["hist"].numpy(), ours._loss_history)
    np.testing.assert_array_equal(a["hist"].numpy(), ref._loss_history)
    np.testing.assert_array_equal(a["counts"].numpy(), ref._loss_counts)
    # rank 1's pairs are in it
    alone = LossSecondMomentResampler(4, history_per_term=2)
    for ts, losses in hist[0]:
        alone.update_with_all_losses(ts, losses)
    assert not np.array_equal(a["hist"].numpy(), alone._loss_history)


def test_global_batchnorm_matches_flax(two_ranks):
    """Two ranks of 2 rows against flax BatchNorm on the 4 rows together:
    the output and the running statistics within 1e-5, float32."""
    import flax.linen as fnn

    bn_x, _, state = two_ranks["bn"]
    x = bn_x.astype(np.float32)
    variables = {"params": {"scale": state["weight"].numpy(), "bias": state["bias"].numpy()},
                 "batch_stats": {"mean": state["running_mean"].numpy(),
                                 "var": state["running_var"].numpy()}}
    y_ref, mut = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                               epsilon=1e-5).apply(
        variables, jnp.asarray(x.transpose(0, 2, 3, 1)), mutable=["batch_stats"])
    outs = [o["bn_float32"] for o in two_ranks["outs"]]
    y = torch.cat([o["y"] for o in outs]).permute(0, 2, 3, 1)
    assert rel_err(y, y_ref) < TOL
    for o in outs:
        assert rel_err(o["mean"], mut["batch_stats"]["mean"]) < TOL
        assert rel_err(o["var"], mut["batch_stats"]["var"]) < TOL


def test_global_batchnorm_gradient_is_the_global_one(two_ranks):
    """float64: each rank's input gradient is its rows of the one-process
    gradient, and the ranks' parameter gradients sum to it (the
    all-reduce carries the gradient)."""
    bn_x, bn_g, state = two_ranks["bn"]
    bn = BatchNorm2d(5).double().train()
    bn.load_state_dict({k: v.double() if v.is_floating_point() else v
                        for k, v in state.items()})
    x = torch.from_numpy(bn_x).requires_grad_()
    y = bn(x)
    (y * torch.from_numpy(bn_g)).sum().backward()
    outs = [o["bn_float64"] for o in two_ranks["outs"]]
    assert float((torch.cat([o["y"] for o in outs]) - y.detach()).abs().max()) < 1e-12
    assert float((torch.cat([o["x_grad"] for o in outs]) - x.grad).abs().max()) < 1e-11
    for name, ref in (("w_grad", bn.weight.grad), ("b_grad", bn.bias.grad)):
        assert float((outs[0][name] + outs[1][name] - ref).abs().max()) < 1e-10
    for o in outs:
        assert float((o["var"] - bn.running_var).abs().max()) < 1e-12


@pytest.mark.parametrize("name", ["s2g_v2_float64", "inpaint_float64"])
def test_ddp_step_matches_one_process_float64(two_ranks, name):
    """Two ranks of 2 rows against the port's one-process step on the 4
    rows, with the speed losses: losses, every gradient within 1e-9 of
    max|g|, BN statistics and the parameters after AdamW (where the
    gradient is at least 1e-4 of max|g|) within 1e-9; both ranks' gradients
    equal."""
    case = two_ranks["steps"][name]
    metrics, grads, state = _single_step(case)
    a, b = (o[name] for o in two_ranks["outs"])
    top = max(float(g.abs().max()) for g in grads.values())
    for out in (a, b):
        for k, v in metrics.items():
            assert out["metrics"][k] == pytest.approx(v, rel=F64_TOL, abs=F64_TOL), k
        for k, g in grads.items():
            assert float((out["grads"][k] - g).abs().max()) <= F64_TOL * top, k
        for k, v in state.items():
            if not v.is_floating_point():
                continue
            keep = torch.ones_like(v, dtype=torch.bool)
            if k in grads:
                # Adam's first step moves p by lr g / (|g| + 1e-8): below
                # 1e-4 of max|g| it amplifies a gradient's rounding
                keep = grads[k].abs() >= 1e-4 * top
            err = (out["state"][k] - v)[keep].abs()
            worst = float(err.max()) if err.numel() else 0.0
            assert worst <= F64_TOL * max(1.0, float(v.abs().max())), k
    for k in a["grads"]:
        assert torch.equal(a["grads"][k], b["grads"][k]), k
    assert {"speed", "speed_l1", "speed_constraint"} <= set(a["metrics"])


def test_ddp_step_matches_jax_data_mesh(two_ranks):
    """float32, two gloo ranks against JAX's step jitted with the batch
    sharded over a 2-device data mesh, with the speed losses: the bars of
    test_torch_port_training.py (losses and BN 1e-5, norm 1e-3, gradients
    outside the trunk 1e-4 of max|g|)."""
    cfg, (losses, grads, stats) = two_ranks["jax"]["s2g_v2_float32"]
    out = two_ranks["outs"][0]["s2g_v2_float32"]
    for k, v in losses.items():
        assert out["metrics"][k] == pytest.approx(float(v), rel=TOL), k
    assert out["metrics"]["grad_norm"] == pytest.approx(
        float(optax.global_norm(grads)), rel=NORM_TOL_F32)
    ref = state_dict_from_jax({"params": grads, "batch_stats": stats}, cfg)
    top = max(float(np.abs(g.numpy()).max()) for g in ref.values())
    checked = 0
    for k, g in out["grads"].items():
        if k.startswith(TRUNK):
            continue
        scale = float(np.abs(ref[k].numpy()).max())
        err = float((g.double() - ref[k].double()).abs().max())
        assert err <= GRAD_TOL * max(scale, 1e-2 * top), (k, err, scale)
        checked += 1
    assert checked > 40
    bn = {k: v for k, v in out["state"].items()
          if k.endswith(("running_mean", "running_var"))}
    assert len(bn) == 2 * 39
    for k, v in bn.items():
        assert rel_err(v, ref[k]) < TOL, k


HEADS = tuple(f"{TRUNK}{kind}_{tag}." for kind in ("conv", "bn", "fc")
              for tag in ("low", "mid", "high"))


def _groups(names):
    """The SE-ResNet trunk's body, its three heads, and the rest."""
    trunk = [k for k in names if k.startswith(TRUNK)]
    heads = [k for k in trunk if k.startswith(HEADS)]
    return {"trunk body": [k for k in trunk if k not in heads],
            "trunk heads": heads,
            "rest": [k for k in names if not k.startswith(TRUNK)]}


def _l2(grads, ref, names):
    """|g - ref| / |ref| over the tensors ``names`` taken as one vector."""
    num = sum(float(((grads[k].double() - ref[k].double()) ** 2).sum()) for k in names)
    den = sum(float((ref[k].double() ** 2).sum()) for k in names)
    return (num / den) ** 0.5


def _bf16_readings(metrics, grads, stats, ref_metrics, ref_grads, ref_stats):
    """The distances of one bf16-encoder step from another: the loss
    terms' worst relative difference, the BN statistics' worst
    max|d|/max|ref|, and |d|/|ref| of each gradient group."""
    out = {"loss": max(abs(metrics[k] - v) / abs(v) for k, v in ref_metrics.items()
                       if k != "grad_norm"),
           "bn": max(rel_err(stats[k], v) for k, v in ref_stats.items())}
    for group, names in _groups(list(ref_grads)).items():
        out[group] = _l2(grads, ref_grads, names)
    return out


def test_ddp_step_bf16_encoder(two_ranks):
    """The flagship's ``Train.encoder_dtype: bfloat16``: two ranks of 2
    rows against three references on the 4 rows, the port's one-process
    bf16 step, JAX's bf16 step on a 2-device data mesh and the port's
    float64 step.  In bf16 the SE-ResNet trunk amplifies rounding about a
    hundredfold (``test_torch_port_bf16_grads.py``), and the global
    BatchNorm rounds some bf16 outputs apart from ``F.batch_norm``, so the
    bar is the references' own spread S, each reading's largest distance
    between two of them.  Held: the loss terms within 2**-8 (bf16's unit
    roundoff) of each reference, BN statistics (max|d|/max|ref|) and each
    gradient group (|d|/|ref|, as one vector) within 2 S of each, a group
    never above BF16_CAP, below the 1.0 a lost gradient reads, and each
    group's norm within BF16_NORM_BAND of float64's.  Found (this file's
    seeds): loss 6.9e-4 / 1.1e-3 / 1.2e-3 against one process / JAX /
    float64; BN 4.6e-3 / 6.4e-3 / 6.7e-3 (S 6.7e-3); the trunk's body
    0.41 / 0.51 / 0.46 (S 0.50), its heads 0.11 / 0.14 / 0.13 (S 0.13),
    the rest 0.059 / 0.062 / 0.035 (S 0.068); norms 0.997-1.014."""
    cfg, (losses, jgrads, jstats) = two_ranks["jax"]["s2g_v2_bfloat16"]
    jax_sd = state_dict_from_jax({"params": jgrads, "batch_stats": jstats}, cfg)
    a, b = (o["s2g_v2_bfloat16"] for o in two_ranks["outs"])

    def stats(state):
        return {k: v for k, v in state.items() if "running_" in k}

    ddp = (a["metrics"], a["grads"], stats(a["state"]))
    refs = {"one process": _single_step(two_ranks["steps"]["s2g_v2_bfloat16"]),
            "jax mesh": ({k: float(v) for k, v in losses.items()},
                         {k: jax_sd[k] for k in a["grads"]}, jax_sd)}
    case64 = dict(two_ranks["steps"]["s2g_v2_bfloat16"], dtype="float64")
    case64["cfg"] = dict(case64["cfg"], encoder_dtype=None)
    refs["float64"] = _single_step(case64)
    refs = {k: (m, g, stats(st)) for k, (m, g, st) in refs.items()}
    names = list(refs)
    spread = {}
    for i, x in enumerate(names):
        for y in names[i + 1:]:
            for key, v in _bf16_readings(*refs[x], *refs[y]).items():
                spread[key] = max(spread.get(key, 0.0), v)
    for name, ref in refs.items():
        found = _bf16_readings(*ddp, *ref)
        print(f"bf16 two ranks against {name}: "
              + ", ".join(f"{k} {v:.2e} (S {spread[k]:.2e})" for k, v in found.items()))
        assert found.pop("loss") <= 2.0 ** -8, name
        for key, v in found.items():
            bar = 2.0 * spread[key] if key == "bn" else min(2.0 * spread[key], BF16_CAP)
            assert v <= bar, (name, key, v, bar)
    g64 = refs["float64"][1]
    for group, sel in _groups(list(g64)).items():
        ratio = (sum(float((a["grads"][k].double() ** 2).sum()) for k in sel)
                 / sum(float((g64[k].double() ** 2).sum()) for k in sel)) ** 0.5
        assert BF16_NORM_BAND[0] <= ratio <= BF16_NORM_BAND[1], (group, ratio)
    for k in a["grads"]:
        assert torch.equal(a["grads"][k], b["grads"][k]), k


# -- the sharded Generator ---------------------------------------------------

def test_fused_noise_clip_base():
    """A shard of clips [c0, c0 + n) draws the unsharded batch's z."""
    whole = fs.fused_noise(1234, 7, 6, 9, 16)
    for c0, n in ((0, 3), (3, 3), (2, 1), (5, 1)):
        assert torch.equal(fs.fused_noise(1234, 7, n, 9, 16, clip_base=c0),
                           whole[c0:c0 + n])
    with pytest.raises(ValueError, match="clip_base"):
        fs.fused_ddim_sample(None, torch.zeros(1, 1, 1), None, None, None, None,
                             None, 1, 1, 1, clip_base=-1)


@pytest.fixture(scope="module")
def gens():
    """The JAX and the port's Generator on the same weights, each over a
    2-device data mesh, float32 fused path (JAX: the Pallas kernel in
    interpret mode under shard_map; port: the plain version)."""
    wav = np.random.default_rng(60).normal(0, 0.3, (4, 16000)).astype(np.float32)
    cfg, variables = jax_variables("s2g_v2", n_layers=1, wav=wav, seed=61)
    sj, tj = jax_make("linear", 100, "ddim10")
    sp, tp = make_diffusion("linear", 100, "ddim10")
    jgen = JaxGenerator(JaxDenoiser(cfg), variables, sj, tj, use_fused=True,
                        fused_dtype=jnp.float32, mesh=jax_make_mesh(n_data=2))
    model = port_model(cfg, variables)
    mesh = make_mesh(devices=["cpu", "cpu"])
    sharded = Generator(model, sp, tp, fused_dtype=torch.float32, mesh=mesh)
    whole = Generator(model, sp, tp, fused_dtype=torch.float32, device="cpu")
    return jgen, sharded, whole, wav


def test_sharded_ddim_matches_jax_mesh(gens):
    jgen, sharded, _, wav = gens
    noise = np.random.default_rng(62).normal(size=(4, 8, D_POSE)).astype(np.float32)
    ref = jgen.generate_sample(jnp.asarray(wav), D_POSE, 8, jax.random.key(0),
                               noise=jnp.asarray(noise))
    assert jgen.last_sample_path == "fused"
    ours = sharded.generate_sample(wav, D_POSE, 8, noise=noise)
    assert sharded.last_sample_path == "fused"
    # float32 both sides through 10 DDIM steps (test_torch_port_generator.py)
    assert rel_err(ours.numpy(), np.asarray(ref)) < 2e-5


@pytest.fixture
def shard_calls(monkeypatch):
    """The clip_base of every fused_ddim_sample call of the Generator."""
    calls = []
    real = generator_module.fused_ddim_sample

    def counted(**kw):
        calls.append(kw.get("clip_base", 0))
        return real(**kw)

    monkeypatch.setattr(generator_module, "fused_ddim_sample", counted)
    return calls


@pytest.mark.parametrize("blend", [False, True])
def test_sharded_ddpm_is_the_unsharded_bit_for_bit(gens, shard_calls, blend):
    """DDPM: two shards of 2 (clip_base 0 and 2) give the unsharded batch
    of 4 exactly; a batch of 3 does not divide and runs unsharded."""
    _, sharded, whole, wav = gens
    kw = {}
    if blend:
        ip = np.zeros((4, 8, D_POSE), np.float32)
        ip[:, :2] = np.random.default_rng(63).normal(size=(4, 2, D_POSE))
        im = np.zeros((4, 8, 1), np.float32)
        im[:, :2] = 1.0
        kw = dict(inpaint_poses=ip, inpaint_masks=im, trans_factor=0.575,
                  pose_seed_len=2)
    outs = [g.generate_sample(wav, D_POSE, 8, sample_alg="ddpm",
                              generator=torch.Generator().manual_seed(64), **kw)
            for g in (whole, sharded)]
    assert shard_calls == [0, 0, 2]
    assert torch.equal(outs[0], outs[1])
    three = {k: v[:3] if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    a = sharded.generate_sample(wav[:3], D_POSE, 8, sample_alg="ddpm",
                                generator=torch.Generator().manual_seed(65), **three)
    b = whole.generate_sample(wav[:3], D_POSE, 8, sample_alg="ddpm",
                              generator=torch.Generator().manual_seed(65), **three)
    assert shard_calls == [0, 0, 2, 0, 0] and torch.equal(a, b)


def test_stream_over_mesh_equals_sequence_over_mesh(gens, shard_calls):
    _, sharded, whole, _ = gens
    sr, fps, seed_len = 16000, 8, 2
    wav_long = np.random.default_rng(66).normal(0, 0.3, (2, 2 * sr)).astype(np.float32)
    noises = [np.random.default_rng(67 + d).normal(size=(2, 8, D_POSE)).astype(np.float32)
              for d in range(3)]
    kw = dict(noise_fn=lambda b0, d: noises[d], trans_factor=0.575)
    mesh = sharded.mesh
    offline = whole.generate_sequence(wav_long, sr, D_POSE, fps, 8, seed_len,
                                      mesh=mesh, **kw)
    assert shard_calls == [0, 1] * 3
    stream = whole.stream(sr, D_POSE, fps, 8, seed_len, mesh=mesh, **kw)
    chunks = []
    for i in range(0, wav_long.shape[1], 5000):
        chunks.extend(stream.push(wav_long[:, i:i + 5000]))
    chunks.extend(stream.flush())
    assert shard_calls == [0, 1] * 6
    np.testing.assert_array_equal(np.concatenate(chunks, axis=1), offline)
    unsharded = whole.generate_sequence(wav_long, sr, D_POSE, fps, 8, seed_len, **kw)
    np.testing.assert_array_equal(unsharded, offline)


def test_generator_mesh_checks():
    model = GestureDenoiser(DenoiserConfig(d_pose=D_POSE, d_model=DMS, heads=HS,
                                           n_layers=1))
    s, tm = make_diffusion("linear", 100, "ddim10")
    mesh = make_mesh(devices=["cpu", "cpu"])
    g = Generator(model, s, tm, mesh=mesh)
    assert g.device == torch.device("cpu") and g.mesh is mesh

    class TwoAxes:
        shape = {"data": 2, "model": 2}

    with pytest.raises(ValueError, match="data-only"):
        check_data_mesh(TwoAxes())
    with pytest.raises(ValueError, match="'data' axis"):
        check_data_mesh(type("NoData", (), {"shape": {"model": 2}})())
    with pytest.raises(ValueError, match="first device"):
        Generator(model, s, tm, device="meta", mesh=mesh)


# -- the CLI's Train.world_size ------------------------------------------------

JOINTS = ["Spine1", "RightArm", "LeftArm"]


def _cli_config(tmp, world, batch_size=4) -> str:
    with open(REPO / "configs" / "beat-ours.json") as f:
        raw = json.load(f)
    raw["Data"].update({
        "synthetic": {"n_train": 4, "n_val": 4, "n_test": 4, "seconds": 4,
                      "n_joints": len(JOINTS)},
        "sample_duration": 4.0, "joints": JOINTS,
        "spt_dir_path": str(tmp / "spt"), "dst_dir_path": str(tmp / "dst")})
    raw["Data"].pop("hierarchy_path")
    raw["Model"]["d_model"] = DMS
    raw["Model"]["Decoder"].update({"heads": HS, "n_layers": 1})
    raw["Model"]["Diffusion"].update({"diffusion_steps": STEPS,
                                      "timestep_respacing": "ddim10"})
    # the float32 encoder: under the bf16 one the global BatchNorm (f32
    # statistics, then the output rounded to bf16) and the one-process
    # F.batch_norm round some bf16 outputs apart, which moves the loss by
    # about 1e-5 of itself
    raw["Train"].update({"batch_size": batch_size, "max_training_steps": "8",
                         "early_stop_threshold_in_step": "8",
                         "world_size": world, "encoder_dtype": None,
                         "Loss": {"speed_loss": 0.1}})
    raw["Train"]["Scheduler"]["d_model"] = DMS
    raw["Meta"] = {"project": "smoke", "log_dir": str(tmp / "log"), "name": "smoke"}
    path = tmp / "cfg.json"
    path.write_text(json.dumps(raw))
    return str(path)


def _curve(tmp):
    files = sorted((tmp / "log" / "smoke").glob("metrics_*.jsonl"))
    assert len(files) == 1, files
    return [json.loads(line) for line in files[0].read_text().splitlines()]


@pytest.fixture(scope="module")
def one_process_run(tmp_path_factory):
    """The CLI's train at ``world_size: 1``, in this process."""
    one = tmp_path_factory.mktemp("one")
    cli.main(["--phase", "train", "--config", _cli_config(one, 1), "--device", "cpu"])
    return one


def _same_curve(one, two):
    """``two`` wrote one metrics file and one checkpoint, and its loss
    curve is ``one``'s: train/loss and every epoch's val losses within
    1e-5 relative (found: 1e-7)."""
    a, b = _curve(one), _curve(two)
    assert [sorted(r) for r in a] == [sorted(r) for r in b] and len(a) >= 3
    for ra, rb in zip(a, b):
        for k, v in ra.items():
            if k.startswith(("train/", "val/")):
                assert rb[k] == pytest.approx(v, rel=1e-5), k
    chkpts = list((two / "log" / "smoke" / "chkpts").iterdir())
    assert sorted(p.name for p in chkpts) == ["chkpt_seed0.pt", "chkpt_seed0.pt.meta.json"]
    tree = torch.load(two / "log" / "smoke" / "chkpts" / "chkpt_seed0.pt",
                      weights_only=True)
    assert not any(k.startswith("module.") for k in tree["model"])
    ref = torch.load(one / "log" / "smoke" / "chkpts" / "chkpt_seed0.pt",
                     weights_only=True)
    assert set(tree["best_params"]) == set(ref["best_params"])


def test_cli_world_size_two_trains_the_same_curve(one_process_run, tmp_path):
    """``Train.world_size: 2`` with ``--device cpu`` spawns 2 gloo ranks
    (the CLI in a subprocess) and trains the one-process run's curve."""
    rc, out, err = _run([sys.executable, "-m", "gesture_diffusion_torch.cli",
                         "--phase", "train", "--config", _cli_config(tmp_path, 2),
                         "--device", "cpu"])
    assert rc == 0, err[-3000:]
    assert "Data parallel over 2 ranks" in out and out.count("Epoch 1/") == 1
    _same_curve(one_process_run, tmp_path)


def test_cli_under_torchrun_trains_the_same_curve(one_process_run, tmp_path):
    """``torchrun --nproc_per_node 2 -m gesture_diffusion_torch.cli --phase
    train --device cpu``: each process is a gloo rank (env://), and the
    run trains the one-process run's curve."""
    rc, out, err = _run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                         "--nproc_per_node", "2", "-m", "gesture_diffusion_torch.cli",
                         "--phase", "train", "--config", _cli_config(tmp_path, "auto"),
                         "--device", "cpu"], threads=1)
    assert rc == 0, err[-3000:]
    assert "Data parallel" not in out and out.count("Epoch 1/") == 1
    _same_curve(one_process_run, tmp_path)


def test_cli_under_torchrun_refuses_another_world_size(tmp_path, monkeypatch):
    """A number in ``Train.world_size`` must be torchrun's ``WORLD_SIZE``;
    the refusal comes before the process joins a group."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="torchrun launched 2 processes"):
        cli.main(["--phase", "train", "--config", _cli_config(tmp_path, 3),
                  "--device", "cpu"])
    assert active_group() is None


def test_cli_failing_ranks_exit_nonzero(tmp_path):
    """A global batch of 3 does not divide over 2 ranks: both fail, the
    CLI ends them and exits non-zero with the error."""
    rc, _, err = _run([sys.executable, "-m", "gesture_diffusion_torch.cli",
                       "--phase", "train", "--config",
                       _cli_config(tmp_path, 2, batch_size=3), "--device", "cpu"])
    assert rc != 0 and "not divisible by 2" in err


# -- profiling -----------------------------------------------------------------

def test_time_fn_and_trace(tmp_path):
    calls = []

    def fn(x):
        calls.append(1)
        return {"y": x * 2.0, "n": [x.sum()]}

    mean, std, out = time_fn(fn, torch.ones(3), repetitions=4, warmup=2,
                             trace_dir=str(tmp_path / "trace"))
    assert len(calls) == 6 and mean >= 0.0 and std >= 0.0
    assert torch.equal(out["y"], torch.full((3,), 2.0))
    assert list((tmp_path / "trace").glob("*.json")), "no trace written"
    with trace(str(tmp_path / "t2")):
        torch.ones(2).sum()
    assert list((tmp_path / "t2").glob("*.json"))
