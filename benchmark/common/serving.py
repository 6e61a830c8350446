"""What the serving traffics share: the weights made from the seed, the
program built on them, the reference built on the same weights once the
program is gone, and the work a window of requests needs."""

from __future__ import annotations

from typing import Optional

import torch

from ..reference import diffusion as rd
from ..reference import model as rm
from . import flops, harness, program, weights


class Serving:
    #: the program's dtype for the fused sampler (None: its own policy);
    #: the benchmark's control sets another
    fused_dtype: Optional[torch.dtype] = None

    def __init__(self, cell):
        self.cell = cell
        self.cfg = cell.config
        self.p = cell.workload["traffic"]
        self.dev = cell.device
        data, gen = self.cfg["Data"], self.cfg["Model"]["Generate"]
        self.c = self.cfg["d_pose"]
        self.t = data["pose_window_len"]
        self.fps, self.sr = data["pose_fps"], data["wav_sr"]
        self.k = gen["pose_seed_len"]
        self.trans = gen.get("trans_factor")
        self.wav_win = int(self.sr * self.t / self.fps)
        self.shapes = rm.build(self.cfg, "meta")
        self.sd = None
        self.gen = None

    def build_program(self) -> None:
        self.sd = weights.make_state_dict(
            self.shapes, self.cell.seed, self.dev,
            self.p.get("layernorm_shifts", True))
        self.gen = program.build_generator(self.cfg, self.sd, self.dev,
                                           self.fused_dtype)
        self.fused = self.gen.fused

    def release(self) -> None:
        self.gen = None
        harness.release_memory()

    def reference(self, operand=None):
        """The plain reference on the run's weights, on the device."""
        ref = rm.build(self.cfg, self.dev)
        ref.load_state_dict(self.sd)
        if operand is not None:
            ref.operand.fn = operand
        return ref

    def schedule(self) -> rd.Schedule:
        diff = self.cfg["Model"]["Diffusion"]
        return rd.Schedule(diff["diffusion_steps"],
                           diff.get("timestep_respacing") or "")

    def window_work(self, n: int) -> dict:
        """Operations of one window of ``n`` clips: the speech encoder,
        the memory rows' projection and the decoder over every step (the
        fused sampler's count, or an eager step's)."""
        ref, d = self.shapes, self.cfg["Model"]["d_model"]
        steps = len(self.schedule())
        m = flops.memory_rows(ref, self.wav_win)
        enc = flops.encoder_flops(ref, n, self.wav_win)
        out = {"steps": steps, "memory_rows": m}
        if self.fused:
            dec = self.cfg["Model"]["Decoder"]
            out["fused_flops"] = flops.fused_flops(
                n, self.t, m + 1, d, self.c, 4 * d, dec["n_layers"], steps)
            out["fused_bytes"] = flops.fused_bytes(
                ref, n, self.t, m + 1, d, self.c, steps)
            out["flops"] = enc + 2.0 * n * m * d * d + out["fused_flops"]
        else:
            out["flops"] = enc + steps * flops.denoise_flops(
                ref, n, self.t, self.c, m, d)
        return out
