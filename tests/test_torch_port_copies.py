"""The port's copies of the JAX package's numpy code stay equal to it.

The port never imports ``videosd_tpu``, so it carries its own copies of the
weight plans, the snapshot loader ``load_model_dir``, the CLIP tokenizer,
the alphas table, the safetensors reader and the host I420 helpers.  Each is held equal to the original here, and the port's modules
own exactly the state-dict keys their plan names.  Also: the port imports
with JAX unavailable.
"""

import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from videosd_tpu.io import safetensors as JS
from videosd_tpu.io import weights as JW
from videosd_tpu.models.clip_text import CLIP_PRESETS as J_CLIP
from videosd_tpu.models.taesd import TAESDConfig as JTAESDConfig
from videosd_tpu.models.unet import UNET_PRESETS as J_UNET
from videosd_tpu.models.vae import VAEConfig as JVAEConfig
from videosd_tpu.models.vae import vae_init
from videosd_tpu.ops import preprocess as JP
from videosd_tpu.schedulers.lcm import LCMSchedulerConfig as JSched
from videosd_tpu.schedulers.lcm import make_alphas_cumprod as j_alphas
from videosd_tpu.text.tokenizer import CLIPTokenizer as JTok
from videosd_tpu_torch.io import safetensors as PS
from videosd_tpu_torch.io import weights as PW
from videosd_tpu_torch.ops import preprocess as PP
from videosd_tpu_torch.models import (
    CLIP_PRESETS,
    UNET_PRESETS,
    VAE_PRESETS,
    AutoencoderKL,
    AutoencoderTiny,
    CLIPTextModel,
    ControlNetModel,
    TAESDConfig,
    UNet2DConditionModel,
)
from videosd_tpu_torch.schedulers.lcm import LCMSchedulerConfig, make_alphas_cumprod
from videosd_tpu_torch.text.tokenizer import CLIPTokenizer

# One torch thread per process, set at import: every xdist worker imports
# every test module, and torch threads on every core of every worker stall
# JAX's interpreted Pallas kernels in the worker that runs them.
torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TAESD = {"sd15": {}, "tiny": {"hidden": 16, "blocks_per_stage": 1}}
# the JAX package's KL VAE configs by family (ModelBundle.random)
_J_VAE = {"sd15": JVAEConfig(), "tiny": JVAEConfig(block_out_channels=(8, 16, 16, 16),
                                                   layers_per_block=1, norm_num_groups=4)}

# (plan, port module, JAX config table, port config table)
_MODELS = {
    "unet": (PW.unet_plan, JW.unet_plan, UNet2DConditionModel, J_UNET, UNET_PRESETS),
    "controlnet": (PW.controlnet_plan, JW.controlnet_plan, ControlNetModel, J_UNET, UNET_PRESETS),
    "clip": (PW.clip_plan, JW.clip_plan, CLIPTextModel, J_CLIP, CLIP_PRESETS),
    "vae": (PW.vae_plan, JW.vae_plan, AutoencoderKL, _J_VAE, VAE_PRESETS),
}


def _configs(name, family):
    if name == "taesd":
        return JTAESDConfig(**_TAESD[family]), TAESDConfig(**_TAESD[family])
    _, _, _, jtab, ptab = _MODELS[name]
    return jtab[family], ptab[family]


def _plans(name, family):
    jcfg, pcfg = _configs(name, family)
    if name == "taesd":
        return JW.taesd_plan(jcfg), PW.taesd_plan(pcfg), lambda: AutoencoderTiny(pcfg)
    pplan, jplan, ctor, _, _ = _MODELS[name]
    return jplan(jcfg), pplan(pcfg), lambda: ctor(pcfg)


@pytest.mark.parametrize("family", ["tiny", "sd15"])
@pytest.mark.parametrize("name", ["unet", "controlnet", "clip", "taesd", "vae"])
def test_plan_copy_equals_original(name, family):
    jplan, pplan, _ = _plans(name, family)
    assert pplan == jplan


@pytest.mark.parametrize("family", ["tiny", "sd15"])
@pytest.mark.parametrize("name", ["unet", "controlnet", "clip", "taesd", "vae"])
def test_module_keys_equal_plan_keys(name, family):
    _, pplan, ctor = _plans(name, family)
    with torch.device("meta"):
        keys = list(ctor().state_dict())
    assert len(keys) == len(set(keys))
    assert set(keys) == {tk for _, tk, _ in pplan}


@pytest.mark.parametrize("vocab_size", [1000, 49408])
def test_tokenizer_copy_matches_original(vocab_size):
    texts = ["portrait, pixar, cg", "a photo of a CAT &amp; dog", "", "x " * 100, "naïve café 42"]
    ours = CLIPTokenizer(None, vocab_size=vocab_size)
    theirs = JTok(None, vocab_size=vocab_size)
    assert ours.is_fallback and theirs.is_fallback
    np.testing.assert_array_equal(ours(texts), theirs(texts))
    assert (ours.BOT, ours.EOT, ours.pad_id) == (theirs.BOT, theirs.EOT, theirs.pad_id)


@pytest.mark.parametrize(
    "kw",
    [{}, {"beta_schedule": "linear"}, {"beta_schedule": "squaredcos_cap_v2"},
     {"rescale_betas_zero_snr": True}],
    ids=["scaled_linear", "linear", "cosine", "zero_snr"],
)
def test_alphas_cumprod_copy_matches_original(kw):
    ours = make_alphas_cumprod(LCMSchedulerConfig(**kw))
    theirs = j_alphas(JSched(**kw))
    assert ours.dtype == theirs.dtype == np.float32
    np.testing.assert_array_equal(ours, theirs)


def test_safetensors_copy_reads_what_the_original_reads(tmp_path):
    path = str(tmp_path / "t.safetensors")
    rng = np.random.default_rng(0)
    tensors = {
        "a": rng.standard_normal((3, 4)).astype(np.float32),
        "b": rng.integers(0, 255, (5,), dtype=np.uint8),
        "c": rng.standard_normal((2, 2, 2)).astype(np.float16),
    }
    PS.write_safetensors(path, tensors)
    ours, theirs = PS.read_safetensors(path), JS.read_safetensors(path)
    assert ours.keys() == theirs.keys() == tensors.keys()
    for k in tensors:
        np.testing.assert_array_equal(ours[k], theirs[k])
        np.testing.assert_array_equal(ours[k], tensors[k])
    ckpt = os.path.join(_REPO, "examples", "toy_tiny_ckpt", "taesd.safetensors")
    for k, v in JS.read_safetensors(ckpt).items():
        np.testing.assert_array_equal(PS.read_safetensors(ckpt)[k], v)


@pytest.mark.parametrize("case", ["complete", "extra_tensor", "missing_tensor", "empty_dir"])
def test_load_model_dir_copy_loads_what_the_original_loads(tmp_path, case):
    """The port's ``load_model_dir`` on a ``vae/`` of two safetensors files
    (the tiny VAE's tensors split between them): the same tensors as JAX's
    (whose tree is exported back to diffusers names), an extra tensor
    ignored by both, a missing one ``KeyError`` on both, and a directory
    without safetensors ``FileNotFoundError`` on both."""
    jcfg, pcfg = _J_VAE["tiny"], VAE_PRESETS["tiny"]
    rng = np.random.default_rng(1)
    shapes = JW.export(vae_init(jax.random.PRNGKey(0), jcfg), JW.vae_plan(jcfg))
    tensors = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in shapes.items()}
    if case == "extra_tensor":
        tensors["encoder.unused"] = np.ones(2, np.float32)
    if case == "missing_tensor":
        del tensors["decoder.conv_out.bias"]
    names = sorted(tensors)
    os.makedirs(tmp_path / "vae")
    if case != "empty_dir":
        for i, part in enumerate((names[::2], names[1::2])):
            PS.write_safetensors(str(tmp_path / "vae" / f"part{i}.safetensors"),
                                 {k: tensors[k] for k in part})
    if case in ("missing_tensor", "empty_dir"):
        err = KeyError if case == "missing_tensor" else FileNotFoundError
        with pytest.raises(err):
            JW.load_model_dir(str(tmp_path), "vae", JW.vae_plan(jcfg))
        with pytest.raises(err):
            PW.load_model_dir(str(tmp_path), "vae", PW.vae_plan(pcfg))
        return
    theirs = JW.export(JW.load_model_dir(str(tmp_path), "vae", JW.vae_plan(jcfg)),
                       JW.vae_plan(jcfg))
    ours = PW.load_model_dir(str(tmp_path), "vae", PW.vae_plan(pcfg))
    assert ours.keys() == theirs.keys()
    for k, v in ours.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), theirs[k])


@pytest.mark.parametrize("name", ["rgb_to_i420_host", "i420_to_rgb_host"])
def test_i420_host_copy_equals_original(name):
    rng = np.random.default_rng(5)
    arg = (rng.integers(0, 256, (32, 48, 3), dtype=np.uint8) if name == "rgb_to_i420_host"
           else rng.integers(0, 256, (48, 48), dtype=np.uint8))
    ours, theirs = getattr(PP, name)(arg), getattr(JP, name)(arg)
    assert ours.dtype == theirs.dtype == np.uint8
    np.testing.assert_array_equal(ours, theirs)


def test_port_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['videosd_tpu'] = None\n"
        "import videosd_tpu_torch.pipelines.lcm_img2img\n"
        "import videosd_tpu_torch.ops, videosd_tpu_torch.schedulers, videosd_tpu_torch.ops.tiling\n"
        "import videosd_tpu_torch.models.vae, videosd_tpu_torch.ops.flops\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'videosd_tpu')"
        " and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env, check=True, timeout=120)


def test_port_sources_name_no_jax_and_no_library_attention():
    """Nothing under ``videosd_tpu_torch/`` nor ``chip_smoke.py`` imports JAX
    or the JAX package, and nothing in the package calls a library
    attention or ``torch.compile`` (``chip_smoke.py`` times
    ``scaled_dot_product_attention`` as a yardstick only)."""
    imports = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|videosd_tpu)(\.|\s|$)", re.M)
    library = re.compile(r"scaled_dot_product_attention|torch\.compile|cudnn_attention")
    paths = [os.path.join(_REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(_REPO, "videosd_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith((".py", ".cu", ".cuh"))]
    assert len(paths) > 20
    for path in paths:
        with open(path, encoding="utf-8") as f:
            text = f.read()
        assert not imports.search(text), path
        if not path.endswith("chip_smoke.py"):
            assert not library.search(text), path
