"""The port's toy trainer and turbo ladder on the CPU.

The counterpart of ``tests/test_train_toy.py`` for
``videosd_tpu_torch/tools/train_toy.py``, at its flags (``--size 32``,
30/8/6 steps, batch 4): the TAESD stage learns, the checkpoint round trip
keeps every trained tensor (through the port's ``ModelBundle.from_dir`` and
the JAX package's ``load_bundle_params``, exactly; the JAX ``save_bundle``
writes the same files from those weights), the trained bundle differs from
the random one, Stage C moves the ControlNet's zero-initialized output off
zero, and the bundle drives the port's frame program and
``tools/turbo_ladder.py`` (``--skip-fps``) at 32x32.
"""

import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videosd_tpu.io import checkpoint as JC
from videosd_tpu.models.clip_text import CLIP_PRESETS as J_CLIP
from videosd_tpu.models.taesd import TAESDConfig as JTAESDConfig
from videosd_tpu.models.unet import UNET_PRESETS as J_UNET
from videosd_tpu_torch.io import weights as PW
from videosd_tpu_torch.pipelines import lcm_img2img as P
from videosd_tpu_torch.tools import train_toy, turbo_ladder

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("toy")
    out = tmp / "ckpt"
    report = train_toy.main([
        "--out", str(out), "--size", "32", "--ae-steps", "30", "--unet-steps", "8",
        "--cn-steps", "6", "--batch", "4", "--device", "cpu", "--json", str(tmp / "r.json"),
    ])
    assert json.loads((tmp / "r.json").read_text()) == report
    return out, report


def _jax_shell():
    """What the JAX ``load_bundle_params``/``save_bundle`` read of a bundle:
    its family, configs and dtype (no JAX init needed)."""
    return types.SimpleNamespace(
        family="tiny", unet_cfg=J_UNET["tiny"], clip_cfg=J_CLIP["tiny"], clip2_cfg=None,
        taesd_cfg=JTAESDConfig(hidden=16, blocks_per_stage=1), vae_cfg=None, params={},
        dtype=jnp.float32)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np_tree(v) for v in tree]
    return np.asarray(tree)


def test_train_toy_trains_saves_and_reloads(trained):
    out, report = trained
    # 30 adam steps on the tiny TAESD must show learning
    assert report["ae_final_mse"] < 0.8 * report["ae_first_mse"]
    for key in ("ae_holdout_psnr_db", "unet_final_loss", "cn_first_loss", "cn_final_loss",
                "cn_holdout_base_loss", "cn_holdout_cn_loss", "cn_holdout_gain_pct", "cn_t_max"):
        assert np.isfinite(report[key]), key
    assert report["device"] == "cpu"
    meta = json.loads((out / "bundle.json").read_text())
    assert meta == {"family": "tiny", "models": ["unet", "controlnet", "clip", "taesd"]}

    loaded = P.ModelBundle.from_dir(str(out), device="cpu")
    assert loaded.family == "tiny" and loaded.dtype == torch.float32
    # the JAX loader reads the same tensors, exactly
    shell = _jax_shell()
    jparams = JC.load_bundle_params(shell, str(out))
    plans = {"unet": PW.unet_plan(loaded.unet_cfg), "controlnet": PW.controlnet_plan(loaded.unet_cfg),
             "clip": PW.clip_plan(loaded.clip_cfg), "taesd": PW.taesd_plan(loaded.taesd_cfg)}
    for name, plan in plans.items():
        want = PW.state_dict_from_jax(_np_tree(jparams[name]), plan)
        got = loaded.models[name].state_dict()
        assert set(got) == set(want)
        assert all(torch.equal(got[k], want[k]) for k in want), name
    # the JAX save_bundle writes the same files from those weights
    shell.params = jparams
    JC.save_bundle(shell, str(out.parent / "jax_saved"))
    for name in meta["models"] + ["bundle"]:
        ext = ".json" if name == "bundle" else ".safetensors"
        assert (out / f"{name}{ext}").read_bytes() == (out.parent / "jax_saved" /
                                                       f"{name}{ext}").read_bytes(), name

    fresh = P.ModelBundle.random("tiny", dtype=torch.float32, device="cpu")
    key = "encoder.layers.0.weight"
    assert not torch.allclose(fresh.models["taesd"].state_dict()[key],
                              loaded.models["taesd"].state_dict()[key])
    # Stage C moved the ControlNet's zero-initialized output off zero
    assert loaded.models["controlnet"].controlnet_mid_block.weight.abs().max() > 0

    # the trained bundle drives the frame program
    prog = P.build_frame_program(loaded, P.FrameSpec(batch=1, height=32, width=32, steps=2))
    embeds, _ = P.build_prompt_encoder(loaded)(loaded.tokenizer(["portrait, pixar, cg"]))
    img, lat = prog(np.zeros((1, 32, 32, 3), np.uint8), embeds, [0.6], [5.0], [2.0], [23])
    assert img.shape == (1, 32, 32, 3) and img.dtype == torch.uint8
    assert torch.isfinite(lat).all()


def test_turbo_ladder_runs_on_the_trained_bundle(trained, tmp_path):
    out, _ = trained
    rows = turbo_ladder.main([
        "--weights", str(out), "--size", "32", "--steps", "2", "--skip-fps", "--device", "cpu",
        "--quality-frames", "2", "--seeds", "1", "--ladder", "2:1,1:2,2:2+last",
        "--json", str(tmp_path / "ladder.json"),
    ])
    assert [(r["cn_interval"], r["dc_interval"], r["refresh_last"]) for r in rows] == [
        (1, 1, False), (2, 1, False), (1, 2, False), (2, 2, True)]
    assert rows[0]["psnr_mean"] == float("inf") and rows[0]["ssim_mean"] == 1.0
    for r in rows[1:]:
        assert r["psnr_min"] > 0  # a number (inf where the knob changed nothing)
        assert 0.0 < r["ssim_min"] <= 1.0
        assert "fps" not in r
    assert json.loads((tmp_path / "ladder.json").read_text())[1]["cn_interval"] == 2


def test_turbo_ladder_measures_frames_per_second_only_on_the_card():
    with pytest.raises(SystemExit):
        turbo_ladder.main(["--device", "cpu", "--size", "32"])
