#!/usr/bin/env python3
"""Where the float32 train step's SE-ResNet trunk gradients lose precision
on the card: one step at batch 4 (TF32 off, one mel, seeded weights and
data, as ``chip_smoke.py``'s [train-vs-cpu] takes it) for a configuration,
float32 on the CPU and on the card under several cuDNN settings, each held
against the CPU's float64 step.

    python3 tools/trunk_precision.py [--config configs/tedexp-ours.json]

Prints, per setting, the trunk's worst tensor (max|d|/max|g64|) and the
median over the trunk's tensors, and the worst gradient outside the trunk.
Needs CUDA.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import statistics
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", nargs="+",
                        default=["configs/tedexp-ours.json", "configs/beat-ours.json"])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("trunk_precision: needs CUDA", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from gesture_diffusion_torch.models import build_all
    from gesture_diffusion_torch.utils import JsonConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi()

    @contextlib.contextmanager
    def cudnn(deterministic=False, enabled=True):
        old = torch.backends.cudnn.deterministic, torch.backends.cudnn.enabled
        torch.backends.cudnn.deterministic, torch.backends.cudnn.enabled = (
            deterministic, enabled)
        try:
            yield
        finally:
            torch.backends.cudnn.deterministic, torch.backends.cudnn.enabled = old

    settings = {"cuDNN default": {}, "cuDNN deterministic": {"deterministic": True},
                "cuDNN off (native convolutions)": {"enabled": False}}
    for path in args.config:
        cfg = JsonConfig(os.path.join(REPO, path))
        tedexp = "tedexp" in path
        d_pose, window, fps = (126, 34, 15) if tedexp else (cs.D_POSE, cs.WINDOW, cs.FPS)
        ds = cs.synthetic_training_set(cs.TED_BATCH * cs.TED_TRAIN_BATCHES, 97,
                                       window, fps, d_pose) if tedexp else \
            cs.synthetic_training_set(cs.TRAIN_BATCH * cs.TRAIN_BATCHES, 70)
        seed = 99 if tedexp else 5

        def bundle(device):
            return build_all(cfg, d_pose, device=device,
                             generator=torch.Generator().manual_seed(0))

        cpu_b = bundle("cpu")
        batch = {k: torch.from_numpy(v[:4]) for k, v in ds.data.items()}
        g = torch.Generator().manual_seed(seed)
        t = torch.randint(0, cpu_b.schedule.num_timesteps, (4,), generator=g)
        noise = torch.randn(batch["pose"].shape, generator=g)
        weights = {k: v.clone() for k, v in cpu_b.model.state_dict().items()}
        models = {"cpu": lambda: cpu_b.model, "card": lambda: bundle(dev).model}
        with cs.shared_mel(batch["wav"]):
            exact = cs.steps_card_vs_cpu(models, weights, cpu_b.schedule, cfg.Train,
                                         batch, t, noise, dev,
                                         torch.float64)["grads"][0]
            trunk = [k for k in exact if k.startswith(cs.TRUNK)]

            top = max(float(v.abs().max()) for v in exact.values())

            def errors(grads):
                # floored at 1e-2 of the largest max|g|, as chip_smoke.py
                # floors it: the key projections' dconv biases have a
                # gradient of 0 in exact arithmetic
                e = {k: float((grads[k].double() - exact[k]).abs().max()
                              / max(float(exact[k].abs().max()), 1e-2 * top))
                     for k in exact}
                worst = max((e[k], k) for k in trunk)
                outside = max((v, k) for k, v in e.items() if k not in trunk)
                return worst, statistics.median(e[k] for k in trunk), outside

            for label, kw in settings.items():
                with cudnn(**kw):
                    r = cs.steps_card_vs_cpu(models, weights, cpu_b.schedule,
                                             cfg.Train, batch, t, noise, dev,
                                             torch.float32)
                for side, grads in zip(("CPU", "card"), r["grads"]):
                    if side == "CPU" and label != "cuDNN default":
                        continue
                    (w, wk), med, (o, ok) = errors(grads)
                    print(f"[trunk-precision] {path} batch 4, float32 {side}"
                          f"{'' if side == 'CPU' else ', ' + label}: the trunk's "
                          f"worst tensor {w:.3e} ({wk}), median {med:.3e}; worst "
                          f"outside the trunk {o:.3e} ({ok}) [{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
