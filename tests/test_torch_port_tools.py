"""The port's quality gates and tools (``videosd_tpu_torch/tools/``) on the
CPU: ``drifting_frame`` equal to the JAX package's array for array, and
each tool's ``main`` with ``--device cpu`` on the tiny family at 64x64, two
steps and at most four frames, its identity rows held (``flicker``'s
``warm_alpha=0`` row is the plain program's flicker, ``temporal_gate``'s
N = 1 row and ``ref_gate``'s sf = 0 rows are the parity frames bit for
bit, ``taesd_ab``'s routes agree, ``soak``'s graph and program counts stay
flat).  Frames/s are the card's only: here the tools report none.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from videosd_tpu.tools import flicker as JFL
from videosd_tpu_torch import __version__
from videosd_tpu_torch.ops.metrics import psnr
from videosd_tpu_torch.pipelines.lcm_img2img import FrameSpec, ModelBundle, build_frame_program
from videosd_tpu_torch.pipelines.lcm_img2img import build_prompt_encoder
from videosd_tpu_torch.tools import flicker, ref_gate, soak, taesd_ab, temporal_gate
from videosd_tpu_torch.tools.temporal_gate import flicker as flicker_of

# One torch thread per process, set at import: every xdist worker imports
# every test module, and torch threads on every core of every worker stall
# JAX's interpreted Pallas kernels in the worker that runs them.
torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY = os.path.join(_REPO, "examples", "toy_tiny_ckpt")
CPU = ["--device", "cpu", "--size", "64", "--steps", "2"]


@pytest.mark.parametrize("i,h,w", [(0, 64, 64), (5, 32, 48), (23, 64, 96), (40, 16, 16)])
def test_drifting_frame_equals_jax(i, h, w):
    ours = flicker.drifting_frame(i, h, w)
    assert ours.dtype == np.uint8 and ours.shape == (h, w, 3)
    np.testing.assert_array_equal(ours, JFL.drifting_frame(i, h, w))


def test_version_matches_the_jax_package():
    from videosd_tpu import __version__ as j_version

    assert __version__ == j_version


def test_flicker_alpha_zero_row_is_the_plain_program(tmp_path):
    out = tmp_path / "flicker.json"
    rows = flicker.main(["--family", "tiny", *CPU, "--frames", "4", "--alphas", "0,0.5",
                         "--json", str(out)])
    assert [r["warm_alpha"] for r in rows] == [0.0, 0.5]
    assert json.loads(out.read_text()) == rows
    assert all(r["fps"] is None and r["device"] == "cpu" for r in rows)
    # warm_alpha = 0 is the frame without a warm start, bit for bit
    bundle = ModelBundle.random("tiny", dtype=torch.float32, device="cpu")
    program = build_frame_program(bundle, FrameSpec(batch=1, height=64, width=64, steps=2))
    embeds, _ = build_prompt_encoder(bundle)(bundle.tokenizer(["portrait, pixar, cg"]))
    outs = [program(flicker.drifting_frame(i, 64, 64)[None], embeds, [0.6], [5.0], [2.0],
                    [23])[0][0].numpy() for i in range(4)]
    want = np.mean([np.mean(np.abs(outs[i + 1].astype(np.float32) - outs[i]))
                    for i in range(3)])
    assert rows[0]["flicker_mean_abs_delta"] == round(float(want), 3)
    assert rows[0]["flicker_mean_abs_delta"] > 0


def test_temporal_gate_every_one_is_identity(tmp_path):
    rows = temporal_gate.main(["--weights", TOY, *CPU, "--frames", "4", "--every", "2",
                               "--json", str(tmp_path / "t.json")])
    assert [r["every"] for r in rows] == [1, 2]
    one, two = rows
    assert one["psnr_min"] == float("inf") and one["psnr_mean_reuse"] is None
    assert one["ssim_min"] == 1.0 and one["flicker"] == one["parity_flicker"]
    assert two["psnr_mean_reuse"] is not None and two["psnr_min"] < float("inf")


def test_ref_gate_sf_zero_is_identity(tmp_path):
    report = ref_gate.main(["--weights", TOY, *CPU, "--frames", "3", "--sf", "0", "0.5",
                            "--no-fps", "--json", str(tmp_path / "r.json")])
    zero, half = report["drift"]
    assert zero["identity_frames"] == 3 and zero["vs_plain_psnr_mean"] is None
    assert zero["flicker"] == zero["plain_flicker"]
    assert half["identity_frames"] < 3 and half["style_fidelity"] == 0.5
    assert "fps_ref" not in report
    with pytest.raises(SystemExit):  # frames/s are the card's only
        ref_gate.main(["--weights", TOY, *CPU, "--fps-only"])


def test_taesd_ab_routes_agree(tmp_path):
    result = taesd_ab.main(["--family", "tiny", *CPU, "--variants", "unpacked,packed,pallas",
                            "--json", str(tmp_path / "a.json")])
    assert set(result["psnr_db"]) == {"packed", "pallas"}
    assert all(v > 40 for v in result["psnr_db"].values()), result
    assert result["pairs"] == [] and result["probe_ms"] == {}  # timings: the card only


def test_soak_counts_stay_flat(tmp_path):
    args = ["--minutes", "0.1", "--streams", "2", "--family", "tiny", "--size", "64", "--steps",
            "2", "--hz", "4", "--churn-every", "2", "--sample-every", "1.5", "--device", "cpu",
            "--json", str(tmp_path / "s.json")]
    report = soak.main(args)
    assert report["frames_served"] > 0 and len(report["samples"]) >= 2
    assert report["programs_stable"] and report["rss_ok"]
    assert report["graphs_final"] == 0  # no CUDA graph off the card
    assert report["programs_compiled_final"] >= 3


def test_tools_run_as_modules():
    """``python -m videosd_tpu_torch.tools.<tool> --help`` for each tool,
    without JAX: the modules import with JAX unavailable."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['videosd_tpu'] = None\n"
        "import runpy\n"
        "for t in ('flicker', 'temporal_gate', 'ref_gate', 'taesd_ab', 'soak'):\n"
        "    sys.argv = [t, '--help']\n"
        "    try:\n"
        "        runpy.run_module('videosd_tpu_torch.tools.' + t, run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, (t, e.code)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env, timeout=120,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.count("usage:") == 5
