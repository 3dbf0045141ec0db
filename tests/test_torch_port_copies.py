"""The port's copies of the JAX package's numpy code stay equal to it.

The port never imports ``videosd_tpu``, so it carries its own copies of the
weight plans, the snapshot loader ``load_model_dir``, the CLIP tokenizer,
the alphas table, the safetensors reader, the host I420 helpers, the
serving runtime's host code (``config.py``, ``io/discovery.py``, the
dispatch worker, the frame queue with its native source, the telemetry's
timers, the JPEG codec with its native source) and the server's sidecars
(``server/stt.py``, ``server/webrtc.py``, ``promptgen/app.py``).  Each is
held equal to the original here, with the package's own name in place of
``videosd_tpu``'s, and the port's modules own exactly the state-dict keys
their plan names.  Also: the port imports with JAX unavailable.
"""

import ast
import asyncio
import copy
import dataclasses
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from videosd_tpu import config as JCFG
from videosd_tpu.io import discovery as JD
from videosd_tpu.io import lora as JL
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
from videosd_tpu.runtime import dispatch as JDISP
from videosd_tpu.runtime import framequeue as JFQ
from videosd_tpu.runtime import jpegcodec as JJPEG
from videosd_tpu.runtime import telemetry as JTEL
from videosd_tpu.text.tokenizer import CLIPTokenizer as JTok
from videosd_tpu_torch import config as PCFG
from videosd_tpu_torch.io import discovery as PD
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
from videosd_tpu_torch.runtime import dispatch as PDISP
from videosd_tpu_torch.runtime import framequeue as PFQ
from videosd_tpu_torch.runtime import jpegcodec as PJPEG
from videosd_tpu_torch.runtime import telemetry as PTEL
from videosd_tpu_torch.schedulers.lcm import LCMSchedulerConfig, make_alphas_cumprod
from videosd_tpu_torch.text.tokenizer import CLIPTokenizer

# One torch thread per process, set at import: every xdist worker imports
# every test module, and torch threads on every core of every worker stall
# JAX's interpreted Pallas kernels in the worker that runs them.
torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TAESD = {"sd15": {}, "sd21": {}, "tiny": {"hidden": 16, "blocks_per_stage": 1}}
# the JAX package's KL VAE configs by family (ModelBundle.random)
_J_VAE = {"sd15": JVAEConfig(), "sd21": JVAEConfig(),
          "tiny": JVAEConfig(block_out_channels=(8, 16, 16, 16), layers_per_block=1,
                             norm_num_groups=4)}

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


@pytest.mark.parametrize("family", ["tiny", "sd15", "sd21"])
@pytest.mark.parametrize("name", ["unet", "controlnet", "clip", "taesd", "vae"])
def test_plan_copy_equals_original(name, family):
    jplan, pplan, _ = _plans(name, family)
    assert pplan == jplan


@pytest.mark.parametrize("family", ["tiny", "sd15", "sd21"])
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
        "import videosd_tpu_torch.pipelines.reference_attn, videosd_tpu_torch.runtime.engine\n"
        "import videosd_tpu_torch.config, videosd_tpu_torch.io.discovery\n"
        "import videosd_tpu_torch.server.app, videosd_tpu_torch.server.protocol\n"
        "import videosd_tpu_torch.server.stt, videosd_tpu_torch.promptgen.app\n"
        "import videosd_tpu_torch.runtime.jpegcodec\n"
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


# ------------------------------------------------------------ the runtime's copies


def _stripped(node):
    """``node`` without docstrings, as ``ast.dump`` text."""
    node = copy.deepcopy(node)
    for n in ast.walk(node):
        body = getattr(n, "body", None)
        if (isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) and body
                and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            n.body = body[1:] or [ast.Pass()]
    return ast.dump(node)


def _defs(module) -> dict:
    """Top-level functions and classes of ``module``'s source, and each
    class's methods as ``Class.method``."""
    out = {}
    with open(module.__file__, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            # the port's package name stands where the original names its own
            out[node.name] = _stripped(node).replace("videosd_tpu_torch", "videosd_tpu")
        if isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[f"{node.name}.{sub.name}"] = _stripped(sub).replace(
                        "videosd_tpu_torch", "videosd_tpu")
    return out


# (port module, original, names that must be equal in code)
_COPIES = {
    "dispatch": (PDISP, JDISP, ["DispatchWorker"]),
    "framequeue": (PFQ, JFQ, ["_PyQueue", "FrameQueue", "_load", "native_available"]),
    "discovery": (PD, JD, ["find_snapshot", "resolve_weights"]),
    "telemetry": (PTEL, JTEL, ["EMA", "StageTimers", "Telemetry.record_generation",
                               "Telemetry.print_gentime", "Telemetry.snapshot"]),
    "config": (PCFG, JCFG, ["default_options", "coerce_option", "coerce_options",
                            "StreamOptions", "load_config"]),
    # all but _load, which builds into the package's _build/
    "jpegcodec": (PJPEG, JJPEG, ["native_available", "_tls_buf", "_pil_decode", "_jpeg_dims",
                                 "decode_rgb", "decode_i420", "_pil_encode", "encode_rgb",
                                 "encode_i420"]),
}


@pytest.mark.parametrize("name", sorted(_COPIES))
def test_runtime_copy_code_equals_original(name):
    ours, theirs, names = _COPIES[name]
    mine, orig = _defs(ours), _defs(theirs)
    for n in names:
        assert mine[n] == orig[n], f"{name}.{n} differs from its original"


def test_config_copy_equals_original():
    """The copied ServerConfig: the same fields and defaults, the same option
    tables, and from_dict normalizing the same inputs the same way (the
    lora normalizer is a copy of the JAX package's io/lora.py one)."""
    assert _defs(PCFG)["normalize_lora_setting"] == _defs(JL)["normalize_lora_setting"]
    assert PCFG._OPTION_COERCIONS == JCFG._OPTION_COERCIONS
    assert PCFG._OPTION_DEFAULTS == JCFG._OPTION_DEFAULTS
    fields = [(f.name, f.default if f.default is not dataclasses.MISSING else f.default_factory())
              for f in dataclasses.fields(PCFG.ServerConfig)]
    assert fields == [(f.name, f.default if f.default is not dataclasses.MISSING
                       else f.default_factory()) for f in dataclasses.fields(JCFG.ServerConfig)]
    raw = {"family": "tiny", "frame_hw": [64, 48], "output_format": "I420", "quant": "None",
           "lora": ["a.safetensors", {"path": "b", "scale": 0.5}], "lora_scale": 0.8,
           "option_defaults": {"steps": "2", "ref": "false"}, "gpus": 4, "mesh_model": 2,
           "models": {"x": "repo/x", "y": {"model": "repo/y", "lora": "c"}}, "bogus": 1}
    assert dataclasses.asdict(PCFG.ServerConfig.from_dict(raw)) == dataclasses.asdict(
        JCFG.ServerConfig.from_dict(raw))
    for bad in ({"output_format": "yuv"}, {"quant": "int4"}, {"mesh_pipe": 3},
                {"models": {"default": "m"}}, {"gpus": 2, "mesh_data": 3}):
        with pytest.raises(ValueError):
            JCFG.ServerConfig.from_dict(bad)
        with pytest.raises(ValueError):
            PCFG.ServerConfig.from_dict(bad)
    msg = {"strength": "0.8", "steps": "2", "ref": "no", "controlnet": "true", "x": [1]}
    assert PCFG.coerce_options(msg) == JCFG.coerce_options(msg)


@pytest.mark.parametrize("path", ["server/stt.py", "server/webrtc.py", "promptgen/app.py"])
def test_sidecar_copy_equals_original(path):
    """The STT client, the aiortc wiring and the prompt-generator sidecar
    are the JAX package's files with the package name replaced (neither
    imports JAX)."""
    with open(os.path.join(_REPO, "videosd_tpu_torch", path), encoding="utf-8") as f:
        ours = f.read()
    with open(os.path.join(_REPO, "videosd_tpu", path), encoding="utf-8") as f:
        theirs = f.read()
    assert ours.replace("videosd_tpu_torch", "videosd_tpu") == theirs


def test_jpegcodec_native_source_is_a_copy():
    with open(os.path.join(os.path.dirname(PJPEG.__file__), "native", "jpegcodec.cpp")) as f:
        ours = f.read()
    with open(os.path.join(os.path.dirname(JJPEG.__file__), "native", "jpegcodec.cpp")) as f:
        assert ours == f.read()
    assert os.path.dirname(PJPEG._SO).endswith(os.path.join("videosd_tpu_torch", "_build"))


def test_framequeue_native_source_is_a_copy():
    with open(os.path.join(os.path.dirname(PFQ.__file__), "native", "framequeue.cpp")) as f:
        ours = f.read()
    with open(os.path.join(os.path.dirname(JFQ.__file__), "native", "framequeue.cpp")) as f:
        assert ours == f.read()
    # built into the package's git-ignored _build/, not beside the source
    assert os.path.dirname(PFQ._SO).endswith(os.path.join("videosd_tpu_torch", "_build"))


@pytest.mark.parametrize("force_py", [True, False])
def test_framequeue_latest_wins(force_py):
    if not force_py and not PFQ.native_available():
        pytest.skip("no native toolchain")
    fq = PFQ.FrameQueue(2, 8, force_python=force_py)
    a = np.arange(8, dtype=np.uint8)
    b = a[::-1].copy()
    fq.put(0, a)
    id_b = fq.put(0, b)
    out = np.zeros(8, np.uint8)
    fid, _ = fq.take(0, out)
    assert fid == id_b
    np.testing.assert_array_equal(out, b)
    assert fq.take(0, out)[0] == 0  # nothing new
    assert fq.stats()["frames_dropped"] == 1


@pytest.mark.parametrize("force_py", [True, False])
def test_framequeue_per_stream_isolation(force_py):
    if not force_py and not PFQ.native_available():
        pytest.skip("no native toolchain")
    fq = PFQ.FrameQueue(3, 4, force_python=force_py)
    fq.put(1, np.full(4, 7, np.uint8))
    out = np.zeros(4, np.uint8)
    assert fq.take(0, out)[0] == 0
    assert fq.take(1, out)[0] != 0
    np.testing.assert_array_equal(out, 7)


@pytest.mark.parametrize("force_py", [True, False])
def test_pacing_gate(force_py):
    if not force_py and not PFQ.native_available():
        pytest.skip("no native toolchain")
    fq = PFQ.FrameQueue(1, 4, force_python=force_py)
    fq.record_gen(10.0)  # huge gen time
    fq.mark_gen_start()
    assert not fq.pacing_ok(sessions=4, executors=1)
    assert fq.pacing_ok(sessions=0, executors=1)


def test_ema_matches_reference_constants():
    e = PTEL.EMA()
    assert e.value == 0.4
    e.update(1.0)
    assert abs(e.value - (0.95 * 0.4 + 0.05 * 1.0)) < 1e-12


def test_telemetry_snapshot():
    ours, theirs = PTEL.Telemetry(), JTEL.Telemetry()
    for t in (ours, theirs):
        t.record_generation(0.1, batch=2, fill=0.5)
        t.stages.record("pack", 0.01)
    snap = ours.snapshot()
    assert snap["frames_out"] == 2 and snap["batches"] == 1
    assert snap == theirs.snapshot()


def test_dispatch_worker_orders_and_propagates():
    """Results resolve in submission order with pipelining, dispatch and
    finalize exceptions surface through the future, stop() drains."""

    async def run():
        w = PDISP.DispatchWorker(depth=2)
        loop = asyncio.get_running_loop()
        done = []

        def mk(i):
            return w.run(loop, lambda i=i: i * 10, lambda raw: done.append(raw) or raw)

        res = await asyncio.gather(*[mk(i) for i in range(5)])
        assert res == [0, 10, 20, 30, 40]
        assert done == [0, 10, 20, 30, 40]  # finalized oldest-first
        with pytest.raises(RuntimeError):
            await w.run(loop, lambda: (_ for _ in ()).throw(RuntimeError("d")), lambda raw: raw)
        with pytest.raises(ValueError):
            await w.run(loop, lambda: 1, lambda raw: (_ for _ in ()).throw(ValueError("f")))
        assert await w.run(loop, lambda: 7, lambda r: r) == 7  # still serviceable
        w.stop()

    asyncio.run(run())
