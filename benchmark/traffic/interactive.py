"""Live traffic: one speaker's utterance walked window by window, closed
loop.

Request r is ``Generator.generate_sample`` on the window of audio that
starts at r * ``stride_s`` (``batch`` speakers side by side), seeded with
the last ``pose_seed_len`` poses of request r - 1 through the x0 blend
and the configuration's ``trans_factor`` (request 0 with seed poses drawn
from the seed), its x_T drawn from (seed, r).  The poses go to the host
(the renderer's side) before the next request is sent.  The utterance is
``utterance_s`` long and is walked again from its start if the window
outlasts it.

Check: request 0 and ``sample`` - 1 others drawn from the seed, run by
the reference from the same audio, x_T and seed poses (for r > 0 the
program's own poses of request r - 1: the request's input), each judged
by max|program - reference| / max|reference|.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.common import harness, inputs, program
from benchmark.common.serving import Serving
from benchmark.common.timeline import percentile
from benchmark.reference import diffusion as rd

WARMUP = 1 << 30     # the draws of the warm-up request


class Traffic(Serving):
    def setup(self) -> None:
        self.build_program()
        self.n = self.p["batch"]
        self.stride = int(self.p["stride_s"] * self.sr)
        total = int(self.p["utterance_s"] * self.sr)
        self.audio = inputs.speech(self.cell.seed, self.n, total, self.dev)
        self.slots = (total - self.wav_win) // self.stride + 1
        self.mask = torch.zeros((self.n, self.t, 1), device=self.dev)
        self.mask[:, :self.k] = 1.0
        _, self.first_tail = self.draws(0)
        self.seeds, self.outs = [], []
        self.tail = self.first_tail
        self.request(WARMUP)
        self.seeds, self.outs = [], []
        self.tail = self.first_tail

    def draws(self, r: int):
        noise, init = inputs.request_draws(self.cell.seed, r, 1, self.n,
                                           self.t, self.c, self.k, self.dev)
        return noise[0], init

    def window(self, r: int) -> torch.Tensor:
        at = (r % self.slots) * self.stride
        return self.audio[:, at:at + self.wav_win]

    def request(self, r: int) -> dict:
        noise, _ = self.draws(r)
        ip = torch.zeros((self.n, self.t, self.c), device=self.dev)
        ip[:, :self.k] = self.tail
        wav = self.window(r)
        launched = program.fused_launches()
        start = time.perf_counter()
        out = self.gen.generate_sample(
            wav, self.c, self.t, noise=noise, inpaint_poses=ip,
            inpaint_masks=self.mask, trans_factor=self.trans,
            pose_seed_len=self.k)
        dispatched = time.perf_counter()
        host = out.cpu()
        end = time.perf_counter()
        self.seeds.append(self.tail)
        self.outs.append(host)
        self.tail = out[:, -self.k:]
        return {"start": start, "end": end, "dispatch_s": dispatched - start,
                "launches": program.fused_launches() - launched}

    def end_to_end(self, done) -> dict:
        lat = [d["end"] - d["start"] for d in done]
        span = done[-1]["end"] - done[0]["start"]
        return {"window_ms": 1e3 * span / len(done),
                "window_ms.p90": 1e3 * percentile(lat, 90)}

    def work(self, done) -> dict:
        w = self.window_work(self.n)
        return {**w, "windows": len(done),
                "launches": sum(d["launches"] for d in done),
                "flops": w["flops"] * len(done)}

    def sample(self, count: int):
        rng = np.random.default_rng(inputs.substream(self.cell.seed, 3))
        rest = rng.choice(np.arange(1, count), min(self.p["sample"] - 1,
                                                   count - 1), replace=False)
        return [0] + sorted(int(r) for r in rest)

    def check(self, done) -> list:
        return [("pose_gap", self.gap(done, self.reference()),
                 self.p["limit"])]

    def gap(self, done, ref, outs=None) -> float:
        """The worst reading over the sampled requests of the reference
        ``ref`` against ``outs`` (the run's outputs by default)."""
        outs = self.outs if outs is None else outs
        rs = self.sample(len(done))
        sched = self.schedule()
        ramp = rd.seed_ramp(self.trans, self.k, self.t)
        got = rd.ddim(ref, sched, torch.cat([self.window(r) for r in rs]),
                      torch.cat([self.draws(r)[0] for r in rs]),
                      torch.cat([self.seeds[r] for r in rs]), ramp)
        return harness.reading(torch.cat([outs[r] for r in rs]), got)
