"""Tensor parallelism of the port (``parallel/tp.py``) against the JAX
package and against the port's one-process step, on the CPU.

The plan (which kernel is column- or row-parallel) is held against JAX
``tensor_parallel_shardings`` on the same weights for every decoder.  The
steps run over gloo processes on this host, spawned as subprocesses with
a timeout as ``tests/test_torch_port_parallel.py`` spawns them, in two
layouts at once: 1 x 2 (one data row, two model ranks) and 2 x 2.  At
``test_tensor_parallel_train_step_matches_dp``'s shapes (d_pose 12,
d_model 64, 4 heads, 2 layers, batch 8 of 8 frames, 8000-sample wav):
one step against JAX's step on a 2-device data mesh (its loss within
1e-4, as the JAX test holds TP to DP) and against the port's one-process
step (``[train-vs-cpu]``'s float32 bars: loss and BN statistics 1e-5,
every gradient outside the SE-ResNet trunk 1e-5 of max|g|, parameters
after AdamW 1e-6, the SE-ResNet trunk in float64 to 1e-9), also with 3
heads on d_model 48 (a head straddles two ranks) and with dropout 0.1 (1
x 2: one data row draws the one-process masks); the sampler's gather
over the data group; and a
``Trainer`` under tensor parallelism, resumed once, whose checkpoint
serves through a plain ``Generator`` as the one-process run's does.
"""

import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from gesture_diffusion_tpu.interop.torch_import import import_torch_state_dict
from gesture_diffusion_tpu.models import DenoiserConfig as JaxConfig
from gesture_diffusion_tpu.parallel import make_mesh as jax_make_mesh
from gesture_diffusion_tpu.parallel.tp import tensor_parallel_shardings
from gesture_diffusion_torch.diffusion import make_diffusion, make_schedule
from gesture_diffusion_torch.diffusion.resample import LossSecondMomentResampler
from gesture_diffusion_torch.generation import Generator
from gesture_diffusion_torch.models import DenoiserConfig, GestureDenoiser, init_random_
from gesture_diffusion_torch.parallel import (apply_tensor_parallel, make_mesh,
                                              tensor_parallel_plan)
from gesture_diffusion_torch.training import (ArrayDataset, Trainer, make_adamw,
                                              make_train_step)
from test_torch_port_parallel import LOSS_PARAMS, _betas, _free_port, _jax_mesh_step
from torch_port_common import rel_err

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
N, TW, D_POSE, WAV = 8, 8, 12, 8000
TRUNK = "speech_encoder.wav_encoder.feat_extractor."
# [train-vs-cpu]'s float32 bars (the norm's, 1e-3, is also that of
# tests/test_torch_port_training.py: the trunk's gradient dominates it)
TOL, GRAD_TOL, PARAM_TOL, NORM_TOL = 1e-5, 1e-5, 1e-6, 1e-3
# float64, one process against the ranks: sums in other orders only
# (tests/test_torch_port_parallel.py's)
F64_TOL = 1e-9
JAX_LOSS_TOL = 1e-4
SPAWN_TIMEOUT = 240
LAYOUTS = {2: 1, 4: 2}          # world -> n_data
TRAIN_CFG = dict(d_pose=D_POSE, d_model=32, heads=4, n_layers=1)


def _cfg(**kw):
    return {**dict(d_pose=D_POSE, d_model=64, heads=4, n_layers=2), **kw}


# -- the plan ------------------------------------------------------------------------

DECODERS = {
    "oneway_cross_attention": {},
    "cross_attention": {},
    "cross_attention_gcn": dict(d_pose=150, d_model=150, heads=3),
    "unet_attention": dict(channel_mult=(1, 2), attention_resolutions=(1, 2),
                           window_len=10),
}


def _jax_specs(model, cfg, n_model):
    """port name -> "column"/"row"/"replicated" from JAX
    ``tensor_parallel_shardings`` on the same weights: each port tensor
    is filled with its own index, imported, and read back from the leaf."""
    names = list(model.state_dict())
    marked = {k: torch.full_like(v, float(i + 1)) if v.is_floating_point() else v
              for i, (k, v) in enumerate(model.state_dict().items())}
    variables = import_torch_state_dict(marked, cfg)
    mesh = jax_make_mesh(n_data=8 // n_model, n_model=n_model)
    shardings = tensor_parallel_shardings(variables["params"], mesh)
    specs = {}
    for (path, leaf), sh in zip(
            jax.tree_util.tree_flatten_with_path(variables["params"])[0],
            jax.tree.leaves(shardings, is_leaf=lambda x: hasattr(x, "spec"))):
        name = names[int(np.asarray(leaf).flat[0]) - 1]
        specs[name] = {(None, "model"): "column", ("model", None): "row"}.get(
            tuple(sh.spec), "replicated")
    return specs


@pytest.mark.parametrize("decoder", list(DECODERS))
def test_plan_is_the_jax_sharding(decoder):
    """Every 2-D kernel is column-, row-parallel or replicated as JAX
    shards it, at 2 model ranks (and everything replicated at 1); a 2-layer
    oneway model shards 20 kernels, as the JAX test counts."""
    kw = {**_cfg(), **DECODERS[decoder]}
    cfg = DenoiserConfig(decoder_type=decoder, **kw)
    model = GestureDenoiser(cfg)
    jax_cfg = JaxConfig(decoder_type=decoder, **kw)
    plan = tensor_parallel_plan(model, make_mesh(4, 2, ["cpu"] * 8))
    ref = _jax_specs(model, jax_cfg, 2)
    # JAX leaves biases replicated; the port slices a column-parallel one
    ref = {k: v for k, v in ref.items() if not k.endswith("bias")}
    weights = {k: v for k, v in plan.items() if k in ref}
    assert weights == ref
    kernels = sum(1 for k, v in weights.items() if v != "replicated"
                  and k.endswith("weight"))
    expected = {"oneway_cross_attention": 20, "cross_attention": 2 * 3 * 4 + 2 * 2 + 2,
                "cross_attention_gcn": 2 * 3 * 4 + 2 * 2 + 2, "unet_attention": 0}
    assert kernels == expected[decoder]
    assert set(tensor_parallel_plan(model, make_mesh(8, 1, ["cpu"] * 8)).values()) \
        == {"replicated"}


def test_plan_names_through_lists_and_sequentials():
    """JAX's ``test_tensor_parallel_shardings_handle_list_and_attr_trees``
    rule on a port model: names through a ``ModuleList`` index and an
    ``nn.Sequential`` index (``layers.0.self_attn.query.0.linear``) still
    match, and a bias follows its column-parallel weight."""
    model = GestureDenoiser(DenoiserConfig(**_cfg()))
    plan = tensor_parallel_plan(model, make_mesh(4, 2, ["cpu"] * 8))
    base = "pose_decoder.layers"
    assert plan[f"{base}.0.self_attn.query.0.linear.weight"] == "column"
    assert plan[f"{base}.0.self_attn.query.0.linear.bias"] == "column"
    assert plan[f"{base}.0.self_attn.query.1.conv.weight"] == "replicated"
    assert plan[f"{base}.1.feed_forward.layer1.weight"] == "column"
    assert plan[f"{base}.1.feed_forward.layer2.weight"] == "row"
    assert plan[f"{base}.1.feed_forward.layer2.bias"] == "replicated"
    assert plan[f"{base}.1.cross_attn.output.weight"] == "row"


def test_sharding_needs_the_process_groups():
    """A mesh made outside a process group makes no axes: sharding over it
    raises; a Generator refuses a model axis, as JAX's does."""
    model = GestureDenoiser(DenoiserConfig(**_cfg()))
    with pytest.raises(ValueError, match="has no .* axes"):
        apply_tensor_parallel(model, make_mesh(1, 2, ["cpu", "cpu"]))
    sched, tmap = make_diffusion("linear", 50, "ddim10")
    with pytest.raises(ValueError, match="data-only"):
        Generator(model, sched, tmap, mesh=make_mesh(1, 2, ["cpu", "cpu"]))


# -- gloo processes ---------------------------------------------------------------------

_WORKER = r"""
import sys
rank, world, n_data, port, work = (int(sys.argv[1]), int(sys.argv[2]),
                                   int(sys.argv[3]), sys.argv[4], sys.argv[5])
sys.path.insert(0, %(repo)r)
import torch
torch.set_num_threads(1)
from gesture_diffusion_torch.diffusion import make_schedule
from gesture_diffusion_torch.diffusion.resample import LossSecondMomentResampler
from gesture_diffusion_torch.models import DenoiserConfig, GestureDenoiser
from gesture_diffusion_torch.parallel import (active_group, apply_tensor_parallel,
                                              full_state_dict, gather_full,
                                              init_distributed, make_mesh, model_axis)
from gesture_diffusion_torch.training import (ArrayDataset, Trainer, make_adamw,
                                              make_train_step)

init_distributed(f"localhost:{port}", world, rank)
n_model = world // n_data
mesh = make_mesh(n_data, n_model, ["cpu"] * world)
row = active_group()[0]
assert (row, model_axis()[0]) == divmod(rank, n_model)
assert active_group()[1] == n_data
inp = torch.load(f"{work}/inputs.pt", weights_only=True)
sched = make_schedule(inp["betas"].numpy())
out = {}

def sharded(cfg, state):
    model = GestureDenoiser(DenoiserConfig(**cfg))
    model.load_state_dict(state)
    plan = apply_tensor_parallel(model, mesh)
    return model, plan

# 1. one step per case on this data row's rows
for name, case in inp["steps"].items():
    if world not in case["worlds"]:
        continue
    model, plan = sharded(case["cfg"], case["state"])
    dtype = getattr(torch, case["dtype"])
    model.to(dtype)
    opt = make_adamw(model.parameters(), case["lr"], 0.0)
    step = make_train_step(model, sched, opt, lambda k: case["lr"], case["loss_params"])
    per = case["pose"].shape[0] // n_data
    rows = slice(row * per, (row + 1) * per)
    metrics = step({"pose": case["pose"][rows].to(dtype), "wav": case["wav"][rows]}, 0,
                   t=case["t"], noise=case["noise"].to(dtype))
    split = {k: tuple(p.shape) for k, p in model.named_parameters()
             if getattr(p, "tp_dim", None) is not None}
    moments = {k: tuple(opt.state[p]["exp_avg"].shape)
               for k, p in model.named_parameters() if k in split}
    grads = gather_full(model, {k: p.grad for k, p in model.named_parameters()})
    out[name] = {"metrics": {k: float(v) for k, v in metrics.items()},
                 "kernels": sum(1 for k, v in plan.items()
                                if v != "replicated" and k.endswith("weight")),
                 "split": split, "moments": moments,
                 "grads": {k: v.clone() for k, v in grads.items()},
                 "state": {k: v.clone() for k, v in full_state_dict(model).items()}}

# 2. the sampler's history: each rank enters its data row's pairs
s = LossSecondMomentResampler(4, history_per_term=2)
for ts, losses in inp["hist"][row] if n_data > 1 else [
        (torch.cat([h[i][0] for h in inp["hist"]]), torch.cat([h[i][1] for h in inp["hist"]]))
        for i in range(2)]:
    s.update_with_local_losses(ts.numpy(), losses.numpy())
out["hist"] = torch.from_numpy(s._loss_history.copy())

# 3. a Trainer with the loss-aware sampler: one epoch, then a fresh one
# resumes from its checkpoint for a second
tr = inp["trainer"]

def dataset(arrays):
    ds = ArrayDataset({k: v.numpy() for k, v in arrays.items()})
    ds.data["pose"] = arrays["pose"].numpy()      # float64, as the model
    return ds

log_dir = f"{work}/run{world}"
for epochs in (1, 2):
    model, _ = sharded(tr["cfg"], tr["state"])
    model.double()
    trainer = Trainer(model, sched, make_adamw(model.parameters(), tr["lr"], 0.0),
                      lambda k: tr["lr"], dataset(tr["train"]), dataset(tr["val"]),
                      batch_size=tr["batch"], log_dir=log_dir, seed=0, loss_params=tr["loss_params"],
                      schedule_sampler="loss-second-moment", device="cpu")
    trainer.train(epochs)
out["sampler_counts"] = torch.from_numpy(trainer.sampler._loss_counts.copy())
out["sampler_history"] = torch.from_numpy(trainer.sampler._loss_history.copy())
if rank == 0:
    torch.save(out, f"{work}/out_{world}.pt")
print("DONE", rank, flush=True)
"""


def _one_process_step(case):
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


def _trainer_data(rng):
    def split(n):
        return {"pose": 0.5 * rng.normal(size=(n, TW, D_POSE)),
                "wav": rng.normal(0, 0.3, (n, WAV)).astype(np.float32)}
    return split(16), split(8)


def _dataset(arrays):
    """An ArrayDataset whose poses stay float64 (it keeps float32 arrays):
    the Trainer's float64 run draws its noise in the poses' dtype."""
    ds = ArrayDataset({k: v.numpy() for k, v in arrays.items()})
    ds.data["pose"] = arrays["pose"].numpy()
    return ds


def _one_process_trainer(tr, log_dir):
    for epochs in (1, 2):
        model = GestureDenoiser(DenoiserConfig(**tr["cfg"])).double()
        model.load_state_dict(tr["state"])
        trainer = Trainer(model, make_schedule(_betas()),
                          make_adamw(model.parameters(), tr["lr"], 0.0),
                          lambda k: tr["lr"], _dataset(tr["train"]),
                          _dataset(tr["val"]), batch_size=tr["batch"],
                          log_dir=str(log_dir), seed=0,
                          loss_params=tr["loss_params"],
                          schedule_sampler="loss-second-moment", device="cpu")
        trainer.train(epochs)
    return trainer


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """Inputs, rank 0's results of both layouts, the JAX data-mesh step
    and the one-process references."""
    work = tmp_path_factory.mktemp("tp")
    rng = np.random.default_rng(0)
    pose = rng.normal(size=(N, TW, D_POSE)).astype(np.float32)
    wav = rng.normal(0, 0.3, (N, WAV)).astype(np.float32)
    t = rng.integers(0, 50, N)
    noise = rng.normal(size=(N, TW, D_POSE)).astype(np.float32)
    # weights drawn in the port and carried to JAX by its importer: no JAX
    # init runs
    model = init_random_(GestureDenoiser(DenoiserConfig(**_cfg())),
                         torch.Generator().manual_seed(5))
    jax_cfg = JaxConfig(**_cfg())
    variables = jax.tree.map(np.asarray, import_torch_state_dict(model.state_dict(),
                                                                 jax_cfg))
    jax_losses, _, _ = _jax_mesh_step(jax_cfg, variables, {"pose": pose, "wav": wav},
                                      t, noise)
    common = {"pose": torch.from_numpy(pose), "wav": torch.from_numpy(wav),
              "t": torch.from_numpy(t), "noise": torch.from_numpy(noise),
              "loss_params": LOSS_PARAMS, "lr": 1e-3, "dtype": "float32"}
    steps = {"jax": {**common, "cfg": _cfg(), "worlds": (2, 4),
                     "state": model.state_dict()},
             "float64": {**common, "cfg": _cfg(), "worlds": (2, 4), "dtype": "float64",
                         "state": model.state_dict()}}
    for name, kw, worlds in (("straddle", dict(d_model=48, heads=3), (2, 4)),
                             ("dropout", dict(dropout=0.1), (2,))):
        cfg = _cfg(**kw)
        state = init_random_(GestureDenoiser(DenoiserConfig(**cfg)),
                             torch.Generator().manual_seed(6)).state_dict()
        steps[name] = {**common, "cfg": cfg, "worlds": worlds, "state": state}
    train, val = _trainer_data(np.random.default_rng(9))
    trainer = {"cfg": TRAIN_CFG, "lr": 1e-3, "batch": 8, "loss_params": LOSS_PARAMS,
               "train": {k: torch.from_numpy(v) for k, v in train.items()},
               "val": {k: torch.from_numpy(v) for k, v in val.items()},
               "state": init_random_(GestureDenoiser(DenoiserConfig(**TRAIN_CFG)),
                                     torch.Generator().manual_seed(7)).state_dict()}
    hist = [[(torch.from_numpy(rng.integers(0, 4, k)),
              torch.from_numpy(rng.gamma(2.0, 1.0, k).astype(np.float32)))
             for k in ks] for ks in ((3, 2), (1, 0))]
    torch.save({"steps": steps, "hist": hist, "trainer": trainer,
                "betas": torch.from_numpy(_betas())}, work / "inputs.pt")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    script = _WORKER % {"repo": str(REPO)}
    procs = []
    for world, n_data in LAYOUTS.items():
        port = _free_port()
        procs += [subprocess.Popen(
            [sys.executable, "-c", script, str(r), str(world), str(n_data),
             str(port), str(work)], cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, start_new_session=True)
            for r in range(world)]
    refs = {name: _one_process_step(case) for name, case in steps.items()}
    ref_trainer = _one_process_trainer(trainer, work / "run1")
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT))
    except subprocess.TimeoutExpired:
        for p in procs:
            os.killpg(p.pid, signal.SIGKILL)
        pytest.fail("the gloo ranks did not finish in time")
    for p, (out, err) in zip(procs, logs):
        assert p.returncode == 0 and "DONE" in out, err[-3000:]
    outs = {world: torch.load(work / f"out_{world}.pt", weights_only=True)
            for world in LAYOUTS}
    return {"work": work, "steps": steps, "hist": hist, "trainer": trainer,
            "jax_losses": jax_losses, "refs": refs, "ref_trainer": ref_trainer,
            "outs": outs}


@pytest.mark.parametrize("world", list(LAYOUTS))
def test_tensor_parallel_step_matches_jax_data_mesh(tp_runs, world):
    """JAX's test at the port: the DP x TP step's loss equals JAX's DP
    step's within 1e-4; 20 kernels are split, and they and their AdamW
    moments stay split after the update."""
    out = tp_runs["outs"][world]["jax"]
    for k, v in tp_runs["jax_losses"].items():
        assert abs(out["metrics"][k] - float(v)) < JAX_LOSS_TOL, k
    assert out["kernels"] == 20
    full = tp_runs["refs"]["jax"][2]
    assert len(out["split"]) == 20 + 14      # the column-parallel biases too
    for k, shape in out["split"].items():
        assert shape != tuple(full[k].shape) and out["moments"][k] == shape, k
        assert 2 * int(np.prod(shape)) == full[k].numel(), k


CASES = [(2, "jax"), (4, "jax"), (2, "straddle"), (4, "straddle"), (2, "dropout")]


@pytest.mark.parametrize("world,name", CASES)
def test_tensor_parallel_step_matches_one_process(tp_runs, world, name):
    """Against the port's one-process step on the same weights: loss terms
    and BN statistics 1e-5, gradients outside the trunk 1e-5 of max|g|, the
    norm 1e-3, the parameters after AdamW outside the trunk 1e-6 (where |g|
    is at least 1e-4 of max|g|: Adam's first step turns a near-zero
    gradient's rounding into a whole step).  The SE-ResNet trunk's float32
    gradient is ill-conditioned on random weights (and the distributed path
    takes the global BatchNorm, whose float32 backward rounds apart from
    ``F.batch_norm``'s): it is held in float64, below."""
    metrics, grads, state = tp_runs["refs"][name]
    out = tp_runs["outs"][world][name]
    for k, v in metrics.items():
        tol = NORM_TOL if k == "grad_norm" else TOL
        assert out["metrics"][k] == pytest.approx(v, rel=tol, abs=TOL), k
    top = max(float(g.abs().max()) for g in grads.values())
    for k, g in grads.items():
        if not k.startswith(TRUNK):
            assert float((out["grads"][k] - g).abs().max()) <= GRAD_TOL * top, k
    for k, v in state.items():
        if not v.is_floating_point() or k.startswith(TRUNK) and k in grads:
            continue
        if k.endswith(("running_mean", "running_var")):
            assert rel_err(out["state"][k], v) < TOL, k
            continue
        keep = grads[k].abs() >= 1e-4 * top if k in grads else torch.ones_like(v, dtype=bool)
        err = (out["state"][k] - v)[keep].abs()
        assert (float(err.max()) if err.numel() else 0.0) <= PARAM_TOL, k


@pytest.mark.parametrize("world", list(LAYOUTS))
def test_tensor_parallel_step_matches_one_process_float64(tp_runs, world):
    """In float64 every gradient, the SE-ResNet trunk's included, equals
    the one-process step's within 1e-9 of max|g|, and so do the loss terms
    and the BN statistics."""
    metrics, grads, state = tp_runs["refs"]["float64"]
    out = tp_runs["outs"][world]["float64"]
    for k, v in metrics.items():
        assert out["metrics"][k] == pytest.approx(v, rel=F64_TOL, abs=F64_TOL), k
    top = max(float(g.abs().max()) for g in grads.values())
    for k, g in grads.items():
        assert float((out["grads"][k] - g).abs().max()) <= F64_TOL * top, k
    for k, v in state.items():
        if k.endswith(("running_mean", "running_var")):
            assert float((out["state"][k] - v).abs().max()) <= F64_TOL * float(
                v.abs().max()), k


def test_sampler_gather_is_bit_equal(tp_runs):
    """Under 2 x 2 each data row's pairs enter the history once, through
    the gather over the data group: bit-equal to one process given every
    pair (and so is 1 x 2, whose one row holds them all)."""
    ref = LossSecondMomentResampler(4, history_per_term=2)
    hist = tp_runs["hist"]
    for i in range(2):
        ref.update_with_all_losses(np.concatenate([h[i][0].numpy() for h in hist]),
                                   np.concatenate([h[i][1].numpy() for h in hist]))
    for world in LAYOUTS:
        np.testing.assert_array_equal(tp_runs["outs"][world]["hist"].numpy(),
                                      ref._loss_history)


@pytest.mark.parametrize("world", list(LAYOUTS))
def test_tensor_parallel_trainer_serves_as_one_process(tp_runs, world):
    """A Trainer under tensor parallelism with the loss-aware sampler, one
    epoch then a resume for a second, in float64 (so that Adam's first
    steps see no float32 rounding of near-zero gradients): its sampler saw
    every example once (the counts equal one process's, the histories
    within 1e-6: the key projections' dconv biases, whose gradient is 0 in
    exact arithmetic, take Adam steps of their rounding noise, 1e-5 apart
    after 4 steps while every other parameter is within 3e-9), and its
    checkpoint (whole tensors under the reference's names) serves through
    a plain float32 Generator within 2e-5 of the one-process run's."""
    out, ref = tp_runs["outs"][world], tp_runs["ref_trainer"]
    np.testing.assert_array_equal(out["sampler_counts"].numpy(), ref.sampler._loss_counts)
    np.testing.assert_allclose(out["sampler_history"].numpy(), ref.sampler._loss_history,
                               rtol=1e-6, atol=1e-12)
    sched, tmap = make_diffusion("linear", 50, "ddim10")
    wav = tp_runs["trainer"]["val"]["wav"][:2]
    noise = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, TW, D_POSE)).astype(np.float32))
    samples = []
    for run in (f"run{world}", "run1"):
        tree = torch.load(tp_runs["work"] / run / "chkpts" / "chkpt_seed0.pt",
                          weights_only=True)
        assert tree["step"] == 4
        model = GestureDenoiser(DenoiserConfig(**TRAIN_CFG))
        model.load_state_dict(tree["model"])
        gen = Generator(model, sched, tmap, use_fused=False, device="cpu")
        samples.append(gen.generate_sample(wav, D_POSE, TW, noise=noise))
    assert rel_err(samples[0], samples[1]) < 2e-5
