"""A whole run with the timed path broken underneath reads ``correct``
false, once for each fault the cell can have; the control reads above
the program.  On the CPU at a tiny size (the look for a card skipped);
the control at a cell's own size needs the card."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import control
from benchmark.common import harness

from . import tiny

CELLS = ["beat-interactive", "beat-offline", "tedexp-offline"]
gen_mod = pytest.importorskip("gesture_diffusion_torch.generation.generator")


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = tiny.run(cell)
    assert res["correct"], res["compared"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "compared"


@pytest.mark.parametrize("cell", CELLS)
def test_steps_that_leave_the_state_unchanged(cell, monkeypatch):
    """Every step returns its input: the window comes back as its x_T."""
    monkeypatch.setattr(gen_mod, "fused_ddim_sample",
                        lambda **kw: kw["x_T"].clone())
    monkeypatch.setattr(gen_mod, "ddim_sample_loop",
                        lambda sched, fn, noise, **kw: noise.clone())
    res = tiny.run(cell)
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_altered_where_it_is_produced(cell, monkeypatch):
    real = gen_mod.Generator.generate_sample

    def altered(self, *a, **kw):
        out = real(self, *a, **kw)
        out[:, 5, 3] += 0.05 * out.abs().max()
        return out

    monkeypatch.setattr(gen_mod.Generator, "generate_sample", altered)
    res = tiny.run(cell)
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("cell", ["beat-offline", "tedexp-offline"])
def test_half_of_the_batch_left_out(cell, monkeypatch):
    """Only the first half of each window batch is sampled; the other
    half repeats it."""
    real = gen_mod.Generator.generate_sample

    def half(self, wavs, *a, noise=None, inpaint_poses=None,
             inpaint_masks=None, **kw):
        h = max(1, wavs.shape[0] // 2)
        cut = (lambda x: None if x is None else x[:h])
        out = real(self, wavs[:h], *a, noise=cut(noise),
                   inpaint_poses=cut(inpaint_poses),
                   inpaint_masks=cut(inpaint_masks), **kw)
        reps = -(-wavs.shape[0] // h)
        return out.repeat(reps, 1, 1)[:wavs.shape[0]]

    monkeypatch.setattr(gen_mod.Generator, "generate_sample", half)
    res = tiny.run(cell)
    assert not res["correct"], res["compared"]


def test_one_chip_cells_have_no_exchange_to_leave_out():
    assert all(w["chips"] == 1 for w in tiny.SPEC["workloads"])


@pytest.mark.parametrize("cell", ["beat-interactive", "beat-offline"])
def test_control_reads_above_the_program(cell):
    got = control.readings(tiny.cell(cell, seed=5))
    assert got["control"] > 3 * got["program"], got


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's size")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limit_at_the_cells_size(cell, card):
    w = json.loads((tiny.BENCH / "workloads" / f"{cell}.json").read_text())
    cfg = json.loads((tiny.BENCH / "configs" / f"{w['config']}.json").read_text())
    got = control.readings(harness.Cell(cell, w, cfg, 7, 3.0, False, card))
    assert got["program"] < w["traffic"]["limit"] < got["control"], got
