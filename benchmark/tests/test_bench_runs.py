"""Whole runs of the harness on the CPU (the tiny families), with the timed
path sound and broken, and on the card the output check's control.

The CPU runs skip only the look for a card: ``run.run_cell`` drives the
engine, the cameras, the window and the output check as a run on the card
does, at the tiny sizes of ``tests/data``.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import run as bench_run
from benchmark.cells import ROOT, load_cell

DATA = os.path.join(os.path.dirname(__file__), "data")


def _cell(name: str, **config):
    cell = load_cell(name, os.path.join(DATA, "cells.json"), DATA)
    cell.config.update(config)
    return cell


@pytest.mark.parametrize("name", ["tiny-cam2", "tinyxl-cam2"])
def test_sound_run_is_correct_and_loads_no_jax(name):
    """The fp32 reference agrees with the port's fp32 frame (the tiny limits
    are 1e-4 relative on the latents and half a level on the image, which
    rounding alone takes), and no module of JAX or the JAX package loads."""
    before = set(sys.modules)
    # 4 s: a tiny frame takes 0.1-0.7 s on a shared CPU, so 2 s can hold one
    result = bench_run.run_cell(_cell(name), 2**33 + 5, 4.0, False, "cpu")
    assert result["correct"], result["compared"]
    assert result["failed"] == 0 and result["attempted"] >= 2
    assert set(result["metrics"]) == {"frames_per_s", "latency_p50_ms", "latency_p95_ms",
                                      "setup_s"}
    new = {m.split(".")[0] for m in set(sys.modules) - before}
    assert not new & set(bench_run.FORBIDDEN)
    assert not bench_run.forbidden_modules()


def _step_unchanged(monkeypatch):
    from videosd_tpu_torch.pipelines import lcm_img2img

    monkeypatch.setattr(lcm_img2img, "step", lambda cfg, acp, out, t, tp, sample, **kw:
                        (sample, sample))


def _half_batch(monkeypatch):
    from videosd_tpu_torch.pipelines import lcm_img2img

    body = lcm_img2img.FrameProgram._body

    def half(bundle, spec, **bufs):
        out = body(bundle, spec, **bufs)
        b = out[0].shape[0]
        if b < 2:
            return out
        keep = b // 2  # the rest of the batch left out, its rows the kept rows' mean
        return tuple(torch.cat([x[:keep], x[:keep].float().mean(0, keepdim=True)
                                .to(x.dtype).expand(b - keep, *x.shape[1:])]) for x in out)

    monkeypatch.setattr(lcm_img2img.FrameProgram, "_body", staticmethod(half))


def _answer_altered(monkeypatch):
    from videosd_tpu_torch.pipelines import lcm_img2img

    post = lcm_img2img.postprocess_image
    monkeypatch.setattr(lcm_img2img, "postprocess_image", lambda img: post(img).flip(-1))


@pytest.mark.parametrize("fault", [_step_unchanged, _half_batch, _answer_altered])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch, capsys):
    """Each fault the cells can have (one card: no exchange between chips),
    planted under the timed path, fails the check with the sd15 cells'
    limits and with the tiny cell's; every frame of the window is checked,
    so the batches of two are."""
    with open(os.path.join(ROOT, "benchmark", "configs", "sd15-lcm-cn-taesd-512.json")) as f:
        sd15_limits = json.load(f)["limits"]
    fault(monkeypatch)
    for limits in (None, sd15_limits):
        cell = _cell("tiny-cam2", check_frames=1000)
        # three cameras at 30 frames/s keep the CPU's engine behind, so its
        # batches hold more than one frame
        cell.traffic = dict(cell.traffic, streams=3, fps=[29.5, 30.5],
                            prompts=cell.traffic["prompts"] + ["a kite"])
        if limits:
            cell.config["limits"] = limits
        result = bench_run.run_cell(cell, 31, 3.0, False, "cpu")
        assert not result["correct"], (fault.__name__, result["compared"])
        out, batches = map(int, re.search(r"frames_out (\d+) in (\d+) batches",
                                          capsys.readouterr().err).groups())
        assert out > batches  # a batch held more than one frame


def test_a_cell_is_added_by_files_and_an_entry_alone(tmp_path):
    """A configuration file, a traffic file and a workloads entry make a new
    cell that runs; no file of the harness changes."""
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(DATA, bench_dir)
    shutil.copytree(os.path.join(ROOT, "benchmark", "metrics"), bench_dir / "metrics")
    cfg = json.loads((bench_dir / "configs" / "tiny-cn.json").read_text())
    cfg["stream_options"] = dict(cfg["stream_options"], height=48, width=80)
    (bench_dir / "configs" / "tiny-cn-wide.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench_dir / "traffic" / "cam2-tiny.json").read_text())
    (bench_dir / "traffic" / "cam3-tiny.json").write_text(
        json.dumps(dict(traffic, streams=3, prompts=traffic["prompts"] + ["a kite"])))
    bench = json.loads((bench_dir / "cells.json").read_text())
    bench["workloads"].append({"name": "tiny-wide-cam3", "config": "tiny-cn-wide",
                               "traffic": "cam3-tiny", "chips": 1, "why": "tests"})
    (bench_dir / "cells.json").write_text(json.dumps(bench))
    cell = load_cell("tiny-wide-cam3", str(bench_dir / "cells.json"), str(bench_dir))
    assert cell.traffic["streams"] == 3
    result = bench_run.run_cell(cell, 4, 4.0, False, "cpu")
    assert result["correct"] and result["attempted"] >= 2


@pytest.mark.parametrize("limits_of", [None, "sd15-lcm-cn-taesd-512", "sdxl-lcm-taesd-1024"])
def test_control_fails_the_check(limits_of):
    """The control (the reference with fp8 products, ``control.py``), judged
    by the output check's own rule, fails it at the tiny size: under the
    tiny cell's limits, and under the full cells'."""
    from benchmark import check, control

    cell = _cell("tiny-cam2")
    limits = cell.config["limits"]
    if limits_of:
        with open(os.path.join(ROOT, "benchmark", "configs", limits_of + ".json")) as f:
            limits = json.load(f)["limits"]
    worst = control.readings(cell, 2**34 + 9, 2, "cpu")
    assert not check.passes(worst, limits), (worst, limits)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["sd15-cam4", "sdxl-cam1"])
def test_control_fails_and_the_program_passes_on_the_card(workload):
    """At the cell's own size: the fp8 control fails the check's own rule on
    three seeds, and a short run of the bf16 program passes it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cells run at their published widths")
    from benchmark import check, control

    cell = load_cell(workload)
    limits = cell.config["limits"]
    for seed in (2**35 + 1, 2**35 + 2, 2**35 + 3):
        worst = control.readings(cell, seed, 1, "cuda")
        assert not check.passes(worst, limits), (seed, worst)
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload,
                           "--seed", str(2**35 + 4), "--seconds", "6"],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"]
