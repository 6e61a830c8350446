#!/usr/bin/env python
"""Phase CLI of the port: prep / data / train / eval / eval-time / gen.

    python -m gesture_diffusion_torch.cli --phase train --config configs/beat-ours.json
    python -m gesture_diffusion_torch.cli --phase data --config ... --device cpu

Port of ``gesture_diffusion_tpu/cli.py`` with the same flags (--phase,
--config, --seed), config schema and artifact layout (the windowed data
under ``Data.dst_dir_path``, ``{log_dir}/{name}/chkpts``,
``results/eval_results.json``, ``results/generated.pkl``,
``results/samples/sample_{i}.pkl``).  ``--device`` plays the part that
``JAX_PLATFORMS`` plays for the JAX CLI: the phases run on the card unless
``--device cpu`` asks for the CPU, and without CUDA the CLI raises.
``prep`` reads the BEAT corpus under ``Data.src_dir_path``
(``data/beat.py``, the JAX CLI's samples pickles array for array, without
sklearn) or writes ``Data.synthetic`` samples, as the JAX CLI does.

Differences by design:
  * checkpoints are torch files (``chkpt_seed{seed}.pt``); where a run has
    none, eval, eval-time and gen serve the JAX CLI's
    ``chkpt_seed{seed}.msgpack`` (``interop/flax_msgpack.py``), and
    ``Model.start_chkpt`` may name one; the JAX package reads no ``.pt``;
  * bpd, sampling and sequence noise come from ``torch.Generator``s seeded
    from ``Meta.seed`` (``utils/rng.py``), not from ``jax.random``;
  * settings the port cannot honour raise (``refuse_unported``) in the
    phases that build a model: train, eval, eval-time and gen;
  * the FGD embedding net (``Eval.fgd``) is a torch file beside the
    configured path, with its suffix replaced by ``.pt``; without one, a
    JAX ``.msgpack`` net at the path is loaded.

Data parallelism (``Train.world_size``): ``train`` with N > 1 spawns N
ranks (``torch.multiprocessing``, "spawn"), rank r on ``cuda:r`` over
NCCL, or on the CPU over gloo with ``--device cpu``; "auto" is every
visible GPU on the card and 1 on the CPU; N above the GPUs raises
``make_mesh``'s error.  Under ``torchrun`` each process joins the group
from torchrun's variables and trains on its local GPU; a number in
``Train.world_size`` must then be torchrun's.  A rank that
fails ends the others and the CLI exits non-zero.  In eval, eval-time
and gen a process that sees more than one GPU samples over a mesh of
them (``Generator(mesh=...)``).
"""

import json
import os
import pickle
import socket
import time
from argparse import ArgumentParser

import numpy as np
import torch

from gesture_diffusion_torch.data.beat import preprocess_data
from gesture_diffusion_torch.data.bvh import (ancestor_closure, hierarchy_text,
                                              parse_bvh, prune_hierarchy)
from gesture_diffusion_torch.data.pipeline import load_processed_datasets
from gesture_diffusion_torch.data.pose_converter import PoseTypeConverter
from gesture_diffusion_torch.generation import Generator
from gesture_diffusion_torch.generation.eval_utils import (
    beat_consistency_score, beat_recall_score)
from gesture_diffusion_torch.generation.fgd import (EmbeddingSpaceEvaluator,
                                                    load_or_train_motion_ae)
from gesture_diffusion_torch.interop import flax_msgpack, jax_checkpoint_state_dict
from gesture_diffusion_torch.models import build_all
from gesture_diffusion_torch.models.factory import SUPPORTED_DECODERS
from gesture_diffusion_torch.parallel import (active_group, init_distributed,
                                              is_main_process, make_mesh)
from gesture_diffusion_torch.training import (MetricsLogger, Trainer,
                                              checkpoint_path, load_checkpoint,
                                              make_optimizer, steps_per_epoch)
from gesture_diffusion_torch.utils import JsonConfig, RngStream, parse_steps
from gesture_diffusion_torch.utils.device import resolve_device


def refuse_unported(config) -> None:
    """Raise on a setting the port cannot honour, rather than ignore it,
    before a phase writes anything."""
    train = config.get("Train") or {}
    world = train.get("world_size", "auto")
    if world != "auto" and not (str(world).isdigit() and int(world) >= 1):
        raise ValueError(
            f"Train.world_size={world!r}: give \"auto\" or a number of "
            "processes, one per device")
    model = config.get("Model") or {}
    decoder = (model.get("Decoder") or {}).get("type")
    if decoder is not None and decoder not in SUPPORTED_DECODERS:
        raise ValueError(
            f"Unsupported decoder type {decoder}: the port builds "
            f"{', '.join(SUPPORTED_DECODERS)}")
    encoder = (model.get("Encoder") or {}).get("type", "ha2g")
    if encoder != "ha2g":
        raise ValueError(f"Unsupported encoder type {encoder}: the JAX "
                         "factory and the port build ha2g")


def make_synthetic_samples(config):
    """Create {split}_samples.pkl from noise so every phase runs without
    the BEAT corpus (the JAX CLI's samples, bit for bit)."""
    syn = config.Data.synthetic
    spt = config.Data.spt_dir_path
    os.makedirs(spt, exist_ok=True)
    rng = np.random.default_rng(0)
    fps_src = 120
    seconds = syn.get("seconds", 4)
    n_joints = syn.get("n_joints", 4)
    for split, n in [("train", syn.get("n_train", 8)),
                     ("val", syn.get("n_val", 4)),
                     ("test", syn.get("n_test", 4))]:
        # int casts: JSON configs may give fractional seconds (4.5)
        t = np.linspace(0, seconds, int(seconds * fps_src))[:, None, None]
        freqs = rng.uniform(0.5, 2.0, (n, 1, n_joints * 3))
        pose = 25 * np.sin(2 * np.pi * freqs * t.transpose(1, 0, 2))
        pose = (pose + rng.normal(0, 2, pose.shape)).astype(np.float32)
        wav = rng.normal(
            0, 0.3, (n, int(seconds * config.Data.wav_sr))).astype(np.float32)
        with open(os.path.join(spt, f"{split}_samples.pkl"), "wb") as f:
            pickle.dump({"hid": np.zeros(n), "pose": pose, "wav": wav}, f)
    print(f"[Info] Synthetic samples written to {spt}")


def hierarchy_template(bvh_path, joints=None, extra=("Neck", "Neck1")) -> str:
    """The HIERARCHY text of ``bvh_path`` pruned to the ancestor closure
    of ``joints`` plus those of ``extra`` it has (the neck chain the
    viewer draws); the whole hierarchy when ``joints`` is empty."""
    skel = parse_bvh(bvh_path)
    if joints:
        # extras go through the closure too: prune_hierarchy's walk only
        # reaches joints whose whole parent chain is kept
        keep = ancestor_closure(
            skel, list(joints) + [j for j in extra if j in skel.joints])
        skel = prune_hierarchy(skel, keep)
    return hierarchy_text(skel)


def ensure_hierarchy_template(config):
    """Write ``Data.hierarchy_path`` from the corpus if it is missing: the
    first corpus BVH through ``hierarchy_template`` with the predicted
    joints and ``Data.hierarchy_extra_joints``."""
    hier = config.Data.get("hierarchy_path")
    if not hier or os.path.exists(hier) or config.Data.get("synthetic"):
        return
    import glob

    src = config.Data.src_dir_path
    bvh_paths = [p for hid in config.Data.human_ids
                 for p in sorted(glob.glob(os.path.join(src, str(hid), "*.bvh")))]
    if not bvh_paths:
        raise FileNotFoundError(
            f"hierarchy template {hier} does not exist and no corpus BVH "
            f"was found under {src} to derive it from; run --phase prep "
            "with the corpus available (or provide the file)")
    text = hierarchy_template(
        bvh_paths[0], config.Data.get("joints"),
        config.Data.get("hierarchy_extra_joints", ["Neck", "Neck1"]))
    os.makedirs(os.path.dirname(os.path.abspath(hier)), exist_ok=True)
    with open(hier, "w") as f:
        f.write(text)
    print(f"[Info] Hierarchy template derived from {bvh_paths[0]} -> {hier}")


def preprocess(config, device=None):
    """The samples pickles: synthetic ones for ``Data.synthetic``, else the
    BEAT corpus under ``Data.src_dir_path`` through ``preprocess_data``,
    then the hierarchy template derived from its first BVH."""
    if config.Data.get("synthetic"):
        make_synthetic_samples(config)
        return
    preprocess_data(
        src_dir_path=config.Data.src_dir_path,
        human_ids=config.Data.human_ids,
        pose_fps=config.Data.pose_fps,
        wav_sr=config.Data.wav_sr,
        sample_duration=config.Data.sample_duration,
        spt_dir_path=config.Data.spt_dir_path,
        joints=config.Data.get("joints"))
    ensure_hierarchy_template(config)


def load_datasets(config, device=None):
    """(train, val, test) ``WindowedDataset``s.  Host work by design, on
    any ``device``: the windows are numpy arrays, built and cached on the
    CPU as the JAX package builds them."""
    if config.Data.get("synthetic") and not os.path.exists(
            os.path.join(config.Data.spt_dir_path, "train_samples.pkl")):
        make_synthetic_samples(config)
    return load_processed_datasets(
        pose_fps=config.Data.pose_fps,
        wav_sr=config.Data.wav_sr,
        spt_dir_path=config.Data.spt_dir_path,
        dst_dir_path=config.Data.dst_dir_path,
        pose_window_len=config.Data.pose_window_len,
        pose_stride_len=config.Data.pose_stride_len,
        pose_representation=config.Data.pose_representation)


def _log_dir(config) -> str:
    return os.path.join(config.Meta.log_dir, config.Meta.name)


def world_size(config, device: torch.device) -> int:
    """``Train.world_size``: "auto" is every visible GPU on the card and
    one process on the CPU."""
    world = config.Train.get("world_size", "auto")
    if world == "auto":
        return torch.cuda.device_count() if device.type == "cuda" else 1
    return int(world)


def train_mesh(world: int, device: torch.device):
    """The data axis of ``world`` ranks: the visible GPUs in order (more
    ranks than GPUs raises ``make_mesh``'s error), or ``world`` CPU
    processes."""
    devices = None if device.type == "cuda" else [device] * world
    return make_mesh(n_data=world, devices=devices)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _train_rank(rank: int, raw_config: dict, devices: list, port: int) -> None:
    """One rank of a spawned data-parallel run, on ``devices[rank]``."""
    from torch.distributed import destroy_process_group

    config = JsonConfig(raw_config)
    dev = torch.device(devices[rank])
    if dev.type == "cpu":
        # the ranks share this process's share of the host's cores
        # (OMP_NUM_THREADS or every core); more threads than cores make
        # every collective wait for a descheduled thread
        torch.set_num_threads(max(1, torch.get_num_threads() // len(devices)))
    init_distributed(f"localhost:{port}", len(devices), rank, device=dev)
    np.random.seed(config.Meta.seed % 2 ** 32)
    torch.manual_seed(config.Meta.seed)
    try:
        _train(config, dev)
    finally:
        destroy_process_group()


def _join_torchrun(config, dev: torch.device) -> torch.device:
    """Under torchrun: join its group and return this rank's device (its
    local GPU, or the CPU).  ``Train.world_size`` must be "auto" or
    torchrun's ``WORLD_SIZE``."""
    world = config.Train.get("world_size", "auto")
    launched = int(os.environ["WORLD_SIZE"])
    if world != "auto" and int(world) != launched:
        raise ValueError(
            f"Train.world_size={world!r} but torchrun launched {launched} "
            "processes; give \"auto\" or the same number")
    if active_group() is None:
        init_distributed(device=None if dev.type == "cuda" else dev)
    if is_main_process():
        # build (and cache) the windowed data once, before the other ranks
        # read it
        load_datasets(config)
    torch.distributed.barrier()
    if dev.type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def train_model(config, device=None):
    refuse_unported(config)
    dev = resolve_device(device)
    if "WORLD_SIZE" in os.environ:
        return _train(config, _join_torchrun(config, dev))
    world = world_size(config, dev)
    mesh = train_mesh(world, dev)
    if world == 1:
        return _train(config, dev)
    # the ranks load the data themselves; load (and cache) it once here so
    # that they do not build the windowed arrays concurrently
    load_datasets(config)
    import torch.multiprocessing as mp

    print(f"[Info] Data parallel over {world} ranks: "
          f"{', '.join(str(d) for d in mesh.devices)}")
    # join=True: the first rank to fail ends the others and raises here
    mp.start_processes(_train_rank, nprocs=world, join=True,
                       start_method="spawn",
                       args=(config.to_dict(), [str(d) for d in mesh.devices],
                             _free_port()))


def _train(config, dev: torch.device) -> None:
    """Train in this process on ``dev``: alone, or as one rank of the
    active process group."""
    train_ds, val_ds, _ = load_datasets(config)
    d_pose = train_ds.get_dims()["d_pose"]
    bundle = build_all(config, d_pose, device=dev,
                       dtype=config.Train.get("dtype"),
                       encoder_dtype=config.Train.get("encoder_dtype"))
    optimizer, lr_schedule = make_optimizer(bundle.model, config.Train)
    train_arrays = train_ds.as_arrays()
    # Train.steps_per_call (the JAX trainer's K steps in one compiled call)
    # needs no option here: the port runs K steps as K calls, which
    # computes the same steps
    trainer = Trainer(
        bundle.model, bundle.schedule, optimizer, lr_schedule,
        train_arrays, val_ds.as_arrays(),
        batch_size=config.Train.batch_size,
        log_dir=_log_dir(config),
        seed=config.Meta.seed,
        metric=config.Train.get("metric", "val_loss"),
        goal=config.Train.get("goal", "minimize"),
        loss_params=(dict(config.Train.Loss) if config.Train.get("Loss") else None),
        grad_norm_clip_value=config.Train.get("grad_norm_clip_value"),
        grad_clip_value=config.Train.get("grad_clip_value"),
        config=config.to_dict(),
        start_chkpt=config.Model.get("start_chkpt"),
        schedule_sampler=config.Train.get("schedule_sampler"),
        device=dev)
    per_epoch = max(1, steps_per_epoch(len(train_arrays), config.Train.batch_size))
    max_epochs = max(1, round(
        parse_steps(config.Train.max_training_steps) / per_epoch))
    early_stop = max(1, round(
        parse_steps(config.Train.get("early_stop_threshold_in_step",
                                     config.Train.max_training_steps))
        / per_epoch))
    trainer._print(f"[Info] Max epochs: {max_epochs} | Early stop (epochs): "
                   f"{early_stop}")
    trainer.train(max_epochs, early_stop)


def _is_bn_stat(name: str) -> bool:
    return name.endswith(("running_mean", "running_var"))


def read_jax_checkpoint(path: str, model):
    """(state dict to serve, metadata) of the JAX CLI's checkpoint at
    ``path``: its ``best_params`` with the last state's BatchNorm
    statistics, checked against ``model``'s names and shapes."""
    tree = flax_msgpack.load(path)
    variables = jax_checkpoint_state_dict(tree, model.cfg)
    try:
        check = model.load_state_dict(variables, strict=False)
    except RuntimeError as e:
        raise ValueError(f"{path}: checkpoint does not match the current "
                         f"model ({str(e).splitlines()[0]}); fix the config") from e
    if check.missing_keys:
        raise ValueError(f"{path}: checkpoint lacks {check.missing_keys[:5]}")
    meta = {}
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    return variables, meta


def load_eval_objs(config, device=None):
    """(checkpoint metadata, test dataset, ``Generator`` on the run's best
    weights with the last state's BatchNorm statistics, the pairing of the
    JAX CLI's ``best_params`` and ``state.batch_stats``)."""
    refuse_unported(config)
    dev = resolve_device(device)
    _, _, test_ds = load_datasets(config)
    d_pose = test_ds.get_dims()["d_pose"]
    bundle = build_all(config, d_pose, device=dev)
    chkpt = checkpoint_path(_log_dir(config), config.Meta.seed)
    jax_chkpt = os.path.splitext(chkpt)[0] + ".msgpack"
    if os.path.exists(chkpt):
        print(f"[Info] Load chkpt from {chkpt}")
        like = bundle.model.state_dict()
        tree, meta = load_checkpoint(chkpt, {"model": like, "best_params": like},
                                     map_location=dev)
        variables = {**tree["best_params"], **{
            k: v for k, v in tree["model"].items() if _is_bn_stat(k)}}
    elif os.path.exists(jax_chkpt):
        print(f"[Info] Load the JAX package's chkpt from {jax_chkpt}")
        variables, meta = read_jax_checkpoint(jax_chkpt, bundle.model)
    else:
        raise FileNotFoundError(
            f"{chkpt}: no checkpoint (nor the JAX package's {jax_chkpt}); "
            "run --phase train first")
    # a process that sees more than one GPU samples over all of them: one
    # kernel instance per GPU; a batch that does not divide (eval-time's
    # batch of 1) runs on the first
    mesh = None
    if (dev.type == "cuda" and dev.index in (None, 0)
            and torch.cuda.device_count() > 1 and active_group() is None):
        mesh = make_mesh()
    generator = Generator(bundle.model, bundle.eval_schedule,
                          bundle.eval_timestep_map,
                          device=None if mesh else dev, mesh=mesh)
    generator.update_variables(variables)
    return meta, test_ds, generator


def _pose_converter(config):
    scaler = os.path.join(config.Data.dst_dir_path, "scaler.npz")
    if not os.path.exists(scaler):
        scaler = os.path.join(config.Data.dst_dir_path, "scaler.jl")
    ensure_hierarchy_template(config)
    return PoseTypeConverter(scaler, config.Data.hierarchy_path,
                             joint_names=config.Data.get("joints"))


def evaluate(config, device=None):
    meta, dataset, generator = load_eval_objs(config, device)
    dev = generator.device
    repr_ = config.Data.pose_representation
    to_dir_vec = None
    if config.Data.get("hierarchy_path"):
        ptc = _pose_converter(config)
        to_dir_vec = {
            "6d": ptc.scaled_ortho6d_to_dir_vec,
            "log_rot": ptc.scaled_log_rot_to_dir_vec,
            "euler": ptc.scaled_euler_to_dir_vec,
        }[repr_]

    samples = dataset.get_samples()
    n = len(samples["pose"])
    batch_size = min(64, n)
    num_batches = -(-n // batch_size)
    gen_cfg = config.Model.get("Generate")
    pose_seed_len = gen_cfg.get("pose_seed_len") if gen_cfg else None
    rngs = RngStream(config.Meta.seed)
    metrics, output_all = {}, []
    for i in range(num_batches):
        st = time.perf_counter()
        poses = samples["pose"][i * batch_size:(i + 1) * batch_size]
        wavs = samples["wav"][i * batch_size:(i + 1) * batch_size]

        diffusion_terms = generator.eval_bpd(
            poses, wavs, generator=rngs.torch("eval/bpd", i, dev),
            pose_seed_len=pose_seed_len,
            t_block=(gen_cfg.get("bpd_t_block", 1) if gen_cfg else 1))
        for name, value in diffusion_terms.items():
            # per-batch 1/num_batches weighting slightly over-weights a
            # ragged final batch: kept for compatibility with the reference
            v = float(value.float().mean()) / num_batches
            metrics[name] = metrics.get(name, 0.0) + v

        inpaint_poses = inpaint_masks = None
        if generator.model.cfg.model_type == "inpaint":
            inpaint_poses = poses
            inpaint_masks = np.zeros(poses.shape[:2] + (1,), np.float32)
            inpaint_masks[:, :gen_cfg.pose_seed_len] = 1.0
        out = generator.generate_sample(
            wavs, poses.shape[2], poses.shape[1],
            generator=rngs.torch("eval/sample", i, dev),
            inpaint_poses=inpaint_poses, inpaint_masks=inpaint_masks,
            sample_alg="ddim",
            trans_factor=(gen_cfg.get("trans_factor") if gen_cfg else None),
            pose_seed_len=pose_seed_len).cpu().numpy()

        if to_dir_vec is not None:
            out_dv = to_dir_vec(out)
            gt_dv = to_dir_vec(poses)
            bc = beat_consistency_score(
                out_dv.reshape(*out_dv.shape[:2], -1, 3),
                config.Data.pose_fps, ptc.angle_pairs,
                wavs, config.Data.wav_sr) / num_batches
            br = beat_recall_score(
                out_dv.reshape(*out_dv.shape[:2], -1, 3),
                gt_dv.reshape(*gt_dv.shape[:2], -1, 3),
                config.Data.pose_fps, ptc.angle_pairs) / num_batches
            metrics["beat_consistency"] = metrics.get("beat_consistency", 0.0) + bc
            metrics["beat_recall"] = metrics.get("beat_recall", 0.0) + br

        output_all.append(out)
        print(f"[Info] Batch {i + 1}/{num_batches} | "
              f"{time.perf_counter() - st:.2f}s")

    # FGD in embedding space (Eval.fgd), on a net fit to the train split
    fgd_cfg = (config.get("Eval") or {}).get("fgd")
    if fgd_cfg is not None:
        train_ds, _, _ = load_datasets(config)
        # trained once (seeded) and kept, so consecutive evals score with
        # the same net
        net = load_or_train_motion_ae(
            fgd_cfg.get("eval_net_path")
            or os.path.join(_log_dir(config), "fgd_motion_ae.pt"),
            train_ds.get_samples()["pose"],
            latent_dim=fgd_cfg.get("latent_dim", 32),
            steps=fgd_cfg.get("train_steps", 2000), device=dev)
        ev = EmbeddingSpaceEvaluator(net)
        ev.push_samples(np.concatenate(output_all, axis=0), samples["pose"])
        metrics["fgd"], metrics["feat_dist"] = ev.get_scores()
        metrics["diversity"] = ev.get_diversity_scores()

    test_log = {f"test/{k}": v for k, v in metrics.items()}
    result_dir = os.path.join(_log_dir(config), "results")
    os.makedirs(result_dir, exist_ok=True)
    with open(os.path.join(result_dir, "eval_results.json"), "w") as f:
        json.dump(test_log, f, indent=2)
    # the test metrics join the training run's metrics stream
    run_id = meta.get("run_id")
    if run_id:
        MetricsLogger(_log_dir(config), run_id=run_id).log(test_log)
    with open(os.path.join(result_dir, "generated.pkl"), "wb") as f:
        pickle.dump({"out": np.concatenate(output_all, axis=0),
                     "pose": samples["pose"], "wav": samples["wav"]}, f)
    print(f"[Info] Results written to {result_dir}")
    print(json.dumps(test_log, indent=2))


def eval_infer_time(config, device=None):
    _, dataset, generator = load_eval_objs(config, device)
    samples = dataset.get_samples()
    wavs = samples["wav"][:1]
    d_pose = samples["pose"].shape[2]
    window = samples["pose"].shape[1]
    mean_ms, std_ms, steps_per_sec = generator.eval_infer_time(
        wavs, d_pose, window)
    # the path names what was timed: the fused kernel, or the scan sampler
    print(f"[Info] DDIM loop: {mean_ms:.2f} +- {std_ms:.2f} ms "
          f"({steps_per_sec:.0f} denoise steps/s, "
          f"path={generator.last_sample_path})")


def generate(config, device=None):
    _, dataset, generator = load_eval_objs(config, device)
    ptc = _pose_converter(config) if config.Data.get("hierarchy_path") else None
    seqs = dataset.get_seqs()
    pose_seqs = np.asarray(seqs["pose"])
    gen_cfg = config.Model.Generate

    out_seqs = generator.generate_sequence(
        seqs["wav"], config.Data.wav_sr, pose_seqs.shape[2],
        config.Data.pose_fps, config.Data.pose_window_len,
        gen_cfg.pose_seed_len,
        generator=RngStream(config.Meta.seed).torch("gen", None, generator.device),
        smooth_trans=bool(gen_cfg.get("smooth_transition")),
        trans_factor=gen_cfg.get("trans_factor"),
        init_poses=pose_seqs[:, :gen_cfg.pose_seed_len])

    out_dir = os.path.join(_log_dir(config), "results/samples")
    os.makedirs(out_dir, exist_ok=True)
    repr_ = config.Data.pose_representation
    for i, out_seq in enumerate(out_seqs):
        pose_seq = pose_seqs[i]
        if ptc is not None and repr_ == "6d":
            out_seq = ptc.scaled_ortho6d_to_euler(out_seq)
            pose_seq = ptc.scaled_ortho6d_to_euler(pose_seq)
        elif ptc is not None and repr_ == "log_rot":
            out_seq = ptc.scaled_log_rot_to_euler(out_seq)
            pose_seq = ptc.scaled_log_rot_to_euler(pose_seq)
        path = os.path.join(out_dir, f"sample_{i}.pkl")
        with open(path, "wb") as f:
            pickle.dump({"pose": pose_seq, "wav": np.asarray(seqs["wav"][i]),
                         "out": out_seq}, f)
        print(f"[Info] Saved to {path}")


PHASES = {
    "prep": preprocess,
    "data": load_datasets,
    "train": train_model,
    "eval": evaluate,
    "eval-time": eval_infer_time,
    "gen": generate,
}


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--phase", type=str, required=True,
                        help="Select from [prep, data, train, eval, eval-time, gen].")
    parser.add_argument("--config", type=str, metavar="PATH", required=True)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; the card (cuda) unless 'cpu' is given")
    args = parser.parse_args(argv)
    if args.phase not in PHASES:
        raise ValueError(f"phase {args.phase} not supported.")
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise RuntimeError(f"{e} (on the command line: --device cpu)") from None
    config = JsonConfig(args.config)
    config.update({"Meta.phase": args.phase, "Meta.config_path": args.config,
                   "Meta.seed": args.seed})
    # the reference's fix_seed, plus torch's generator: a fresh model's
    # weights are drawn from it
    np.random.seed(args.seed % 2 ** 32)
    torch.manual_seed(args.seed)
    PHASES[args.phase](config, device=device)


if __name__ == "__main__":
    main()
