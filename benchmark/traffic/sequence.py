"""Offline traffic: batches of long clips through
``Generator.generate_sequence``, closed loop.

Request r is ``clips`` clips of ``clip_s`` seconds (the same seeded audio
in every request), in window batches of ``batch_size``, each window's x_T
and the first window's seed poses drawn from (seed, r); the
configuration's ``smooth_transition`` and ``trans_factor``.  Its output
is ``clips`` x frames of poses on the host; a request's gesture seconds
are clips x frames / pose_fps.

Check: request 0 and, where the window finished more, one other drawn
from the seed; of each, ``sample`` clips, one drawn from each of
``sample`` equal parts of the batch; the reference chains its own
windows over the same audio, x_T and first seed poses, and each clip is
judged by max|program - reference| / max|reference|.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.common import harness, inputs, program
from benchmark.common.serving import Serving
from benchmark.reference import diffusion as rd

WARMUP = 1 << 30


class Traffic(Serving):
    def setup(self) -> None:
        self.build_program()
        self.n = self.p["clips"]
        self.bs = self.p["batch_size"]
        samples = int(self.p["clip_s"] * self.sr)
        self.audio = inputs.speech(self.cell.seed, self.n, samples, self.dev)
        self.audio_host = self.audio.cpu().numpy()
        self.frames, self.windows = rd.window_plan(
            samples, self.sr, self.fps, self.t, self.k)
        self.outs = []
        self.warm_up()

    def warm_up(self) -> None:
        """Every shape the requests use: each window batch size (the last
        batch may be short), seeded."""
        noise, init = self.draws(WARMUP)
        ramp_args = dict(trans_factor=self.trans, pose_seed_len=self.k)
        for b in sorted({min(self.bs, self.n - b0)
                         for b0 in range(0, self.n, self.bs)}):
            mask = torch.zeros((b, self.t, 1), device=self.dev)
            mask[:, :self.k] = 1.0
            ip = torch.zeros((b, self.t, self.c), device=self.dev)
            ip[:, :self.k] = init[:b]
            self.gen.generate_sample(
                self.audio[:b, :self.wav_win], self.c, self.t,
                noise=noise[0, :b], inpaint_poses=ip, inpaint_masks=mask,
                **ramp_args).cpu()

    def draws(self, r: int):
        return inputs.request_draws(self.cell.seed, r, self.windows, self.n,
                                    self.t, self.c, self.k, self.dev)

    def request(self, r: int) -> dict:
        noise, init = self.draws(r)
        init = init.cpu().numpy()
        launched = program.fused_launches()
        start = time.perf_counter()
        out = self.gen.generate_sequence(
            self.audio_host, self.sr, self.c, self.fps, self.t, self.k,
            smooth_trans=bool(self.cfg["Model"]["Generate"].get(
                "smooth_transition")),
            trans_factor=self.trans, init_poses=init, batch_size=self.bs,
            noise_fn=lambda b0, w: noise[w, b0:b0 + self.bs])
        end = time.perf_counter()
        self.outs.append(out)
        return {"start": start, "end": end,
                "gesture_s": out.shape[0] * out.shape[1] / self.fps,
                "launches": program.fused_launches() - launched}

    def end_to_end(self, done) -> dict:
        """Seconds of motion a second, under the cell's metric name
        (``traffic.metric``: configurations whose runs spread differently
        keep bounds of their own)."""
        span = done[-1]["end"] - done[0]["start"]
        return {self.p.get("metric", "gesture_s_per_s"):
                sum(d["gesture_s"] for d in done) / span}

    def work(self, done) -> dict:
        per_batch = [min(self.bs, self.n - b0) for b0 in range(0, self.n, self.bs)]
        flops = sum(self.window_work(b)["flops"] for b in per_batch)
        w = self.window_work(per_batch[0])
        return {**w, "windows": self.windows * len(per_batch) * len(done),
                "launches": sum(d["launches"] for d in done),
                "flops": flops * self.windows * len(done)}

    def sample(self, count: int):
        rng = np.random.default_rng(inputs.substream(self.cell.seed, 3))
        rs = [0] + ([int(rng.integers(1, count))] if count > 1 else [])
        parts = self.p["sample"]
        bounds = np.linspace(0, self.n, parts + 1).astype(int)
        clips = [int(rng.integers(lo, hi)) for lo, hi in zip(bounds, bounds[1:])]
        return rs, clips

    def check(self, done) -> list:
        return [("pose_gap", self.gap(done, self.reference()),
                 self.p["limit"])]

    def gap(self, done, ref, outs=None) -> float:
        outs = self.outs if outs is None else outs
        rs, clips = self.sample(len(done))
        sel = torch.tensor(clips, device=self.dev)
        noise, init, got = [], [], []
        for r in rs:
            nz, ini = self.draws(r)
            noise.append(nz[:, sel])
            init.append(ini[sel])
            got.append(torch.from_numpy(outs[r][clips]))
        ref_out = rd.sequence(ref, self.schedule(),
                              self.audio[sel].repeat(len(rs), 1),
                              torch.cat(noise, dim=1), torch.cat(init),
                              self.cfg)
        return harness.reading(torch.cat(got), ref_out)
