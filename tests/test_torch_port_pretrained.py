"""The port's checkpoint entry points against the JAX package's (fp32, CPU).

* ``ModelBundle.from_pretrained`` on a diffusers-layout snapshot that the
  test writes from one tiny JAX bundle with a KL VAE (JAX ``export`` and
  ``write_safetensors``: ``unet/``, ``text_encoder/`` and ``vae/``, the
  ControlNet and TAESD in their own directories): the JAX and the port
  bundles give the same frame with ``vae="kl"`` and with ``vae="taesd"``,
  at the frame program's bars (latents atol 5e-4 / rtol 1e-4, image within
  1 level), and ``from_dir`` on the snapshot takes the same route.
* A snapshot without ``vae/`` loads as a bundle without a KL VAE; an extra
  tensor is ignored and a missing one raises, on both sides.
* ``from_dir`` on a JAX ``save_bundle`` directory that holds a ``vae``
  (once a ``KeyError`` in the port): the port's KL frame equals JAX's.
No interpreted Pallas kernel runs here.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videosd_tpu.io import weights as JW
from videosd_tpu.io.checkpoint import save_bundle
from videosd_tpu.io.safetensors import read_safetensors, write_safetensors
from videosd_tpu.pipelines import lcm_img2img as J
from videosd_tpu_torch.pipelines import lcm_img2img as P

# one torch thread per process (see tests/test_torch_port_production.py)
torch.set_num_threads(1)

LAT_ATOL, LAT_RTOL, IMG_LEVELS = 5e-4, 1e-4, 1
ARGS = (np.array([0.8], np.float32), np.array([5.0], np.float32), np.array([1.5], np.float32),
        np.array([19], np.int32))
SPEC = {"batch": 1, "height": 64, "width": 64, "steps": 2}


@pytest.fixture(scope="module")
def jax_bundle():
    """A tiny JAX bundle with a KL VAE, its zero-initialized biases and
    ControlNet output convs perturbed, so that loading each of them shows."""
    jb = J.ModelBundle.random("tiny", dtype=jnp.float32, with_kl_vae=True)
    rng = np.random.default_rng(12)

    def perturb(path, a):
        zero = path[-1].key == "bias" or any(
            getattr(k, "key", None) in ("controlnet_down_blocks", "controlnet_mid_block")
            for k in path)
        return rng.normal(0, 0.05, a.shape).astype(np.float32) if zero else np.asarray(a)

    params = jax.tree_util.tree_map_with_path(perturb, jax.tree.map(np.asarray, jb.params))
    bundle = J.ModelBundle(**{**vars(jb), "params": jax.tree.map(jnp.asarray, params)})
    return bundle


def _write(path, params, plan, extra=None):
    os.makedirs(path, exist_ok=True)
    tensors = JW.export(params, plan)
    tensors.update(extra or {})
    write_safetensors(os.path.join(path, "model.safetensors"), tensors)


@pytest.fixture(scope="module")
def snapshot(jax_bundle, tmp_path_factory):
    """(snapshot dir, ControlNet dir, TAESD dir) in the diffusers layout; the
    UNet's file carries one tensor no plan names."""
    jb, root = jax_bundle, tmp_path_factory.mktemp("snapshot")
    extra = {"unused.weight": np.ones((3,), np.float32)}
    _write(root / "model" / "unet", jb.params["unet"], JW.unet_plan(jb.unet_cfg), extra)
    _write(root / "model" / "text_encoder", jb.params["clip"], JW.clip_plan(jb.clip_cfg))
    _write(root / "model" / "vae", jb.params["vae"], JW.vae_plan(jb.vae_cfg))
    _write(root / "cn", jb.params["controlnet"], JW.controlnet_plan(jb.unet_cfg))
    _write(root / "taesd", jb.params["taesd"], JW.taesd_plan(jb.taesd_cfg))
    return str(root / "model"), str(root / "cn"), str(root / "taesd")


def _frames(bundles, vae):
    """(JAX outputs, port outputs) of one frame of each bundle, the prompt
    embedded by each side's own encoder and JAX's noise through the seam."""
    jb, pb = bundles
    frame = np.random.default_rng(3).integers(0, 256, (1, 64, 64, 3), dtype=np.uint8)
    ids = jb.tokenizer(["a watercolor fox"])
    jemb, _ = J.build_prompt_encoder(jb)(jb.params, jnp.asarray(ids, jnp.int32))
    pemb, _ = P.build_prompt_encoder(pb)(pb.tokenizer(["a watercolor fox"]))
    np.testing.assert_allclose(pemb.numpy(), np.asarray(jemb), atol=1e-5, rtol=1e-4)
    jout = J.frame_program(jb.params, J.FrameSpec(**SPEC, vae=vae), jb.unet_cfg, jb.sched_cfg,
                           jb.taesd_cfg, jb.vae_cfg, jb.alphas_cumprod, jb.dtype,
                           jnp.asarray(frame), jemb, *(jnp.asarray(a) for a in ARGS))
    h = 8
    noise = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(19), k),
                                                   (1, h, h, 4), jnp.float32))
                      for k in range(SPEC["steps"] + 1)])
    pout = P.build_frame_program(pb, P.FrameSpec(**SPEC, vae=vae))(frame, pemb, *ARGS,
                                                                  noise=noise)
    return [np.asarray(o) for o in jout], [o.numpy() for o in pout]


def _assert_close(jout, pout):
    assert np.abs(pout[0].astype(int) - jout[0].astype(int)).max() <= IMG_LEVELS
    np.testing.assert_allclose(pout[1], jout[1], atol=LAT_ATOL, rtol=LAT_RTOL)


@pytest.fixture(scope="module")
def pretrained(snapshot):
    model, cn, taesd = snapshot
    kw = dict(family="tiny", controlnet_dir=cn, taesd_dir=taesd)
    jb = J.ModelBundle.from_pretrained(model, dtype=jnp.float32, **kw)
    pb = P.ModelBundle.from_pretrained(model, dtype=torch.float32, device="cpu", **kw)
    return jb, pb


@pytest.mark.parametrize("vae", ["kl", "taesd"])
def test_from_pretrained_frame_matches_jax(pretrained, vae):
    jb, pb = pretrained
    assert "vae" in jb.params and "vae" in pb.models
    _assert_close(*_frames(pretrained, vae))


def test_from_dir_on_a_snapshot_is_from_pretrained(snapshot, pretrained):
    """Without ``bundle.json`` the port's ``from_dir`` loads the snapshot,
    passing ``family`` and the other keywords on (bf16 unless asked)."""
    model, cn, taesd = snapshot
    pb = P.ModelBundle.from_dir(model, family="tiny", controlnet_dir=cn, taesd_dir=taesd,
                                device="cpu")
    assert pb.dtype == torch.bfloat16 and set(pb.models) == set(pretrained[1].models)
    want = pretrained[1].models["vae"].state_dict()
    for key, value in pb.models["vae"].state_dict().items():
        assert torch.equal(value, want[key].bfloat16())


def test_snapshot_without_vae_loads(snapshot, tmp_path):
    """A TAESD-only snapshot (no ``vae/``): both sides load it, without a KL
    VAE, and the port refuses ``vae="kl"`` on it."""
    model = str(tmp_path / "model")
    shutil.copytree(snapshot[0], model, ignore=shutil.ignore_patterns("vae"))
    jb = J.ModelBundle.from_pretrained(model, family="tiny", dtype=jnp.float32)
    pb = P.ModelBundle.from_pretrained(model, family="tiny", dtype=torch.float32, device="cpu")
    assert "vae" not in jb.params and "vae" not in pb.models
    assert "controlnet" not in pb.models  # no ControlNet asked for
    with pytest.raises(ValueError, match="KL VAE"):
        P.build_frame_program(pb, P.FrameSpec(**SPEC, vae="kl", use_controlnet=False))


def test_missing_tensor_raises_and_extra_is_ignored(snapshot, jax_bundle, tmp_path):
    """The snapshot's UNet file holds an extra tensor (both loaders ignore
    it); a UNet file without one planned tensor raises ``KeyError`` on both
    sides, and a ``vae/`` without one leaves the bundle without a KL VAE."""
    assert "unused.weight" in read_safetensors(os.path.join(snapshot[0], "unet",
                                                            "model.safetensors"))
    jb = jax_bundle
    model = str(tmp_path / "model")
    shutil.copytree(snapshot[0], model)
    unet = JW.export(jb.params["unet"], JW.unet_plan(jb.unet_cfg))
    dropped = sorted(unet)[0]
    del unet[dropped]
    write_safetensors(os.path.join(model, "unet", "model.safetensors"), unet)
    with pytest.raises(KeyError, match="missing 1 keys"):
        J.ModelBundle.from_pretrained(model, family="tiny", dtype=jnp.float32)
    with pytest.raises(KeyError, match="missing 1 keys"):
        P.ModelBundle.from_pretrained(model, family="tiny", dtype=torch.float32, device="cpu")
    _write(os.path.join(model, "unet"), jb.params["unet"], JW.unet_plan(jb.unet_cfg))
    vae = JW.export(jb.params["vae"], JW.vae_plan(jb.vae_cfg))
    del vae[sorted(vae)[0]]
    write_safetensors(os.path.join(model, "vae", "model.safetensors"), vae)
    pb = P.ModelBundle.from_pretrained(model, family="tiny", dtype=torch.float32, device="cpu")
    assert "vae" not in pb.models
    # an SDXL family reads the same layout: the tiny snapshot's UNet lacks the
    # text_time add_embedding that a tiny-xl UNet plans, on both sides
    with pytest.raises(KeyError, match="missing"):
        J.ModelBundle.from_pretrained(model, family="tiny-xl", dtype=jnp.float32)
    with pytest.raises(KeyError, match="missing"):
        P.ModelBundle.from_pretrained(model, family="tiny-xl", dtype=torch.float32, device="cpu")


def test_from_dir_loads_a_save_bundle_dir_with_a_vae(jax_bundle, tmp_path):
    """JAX's ``save_bundle`` writes a ``vae`` model whenever the bundle has
    one; the port's ``from_dir`` loads it (it once raised ``KeyError``) and
    its KL frame equals the JAX bundle's."""
    save_bundle(jax_bundle, str(tmp_path))
    pb = P.ModelBundle.from_dir(str(tmp_path), device="cpu")
    assert pb.dtype == torch.float32 and "vae" in pb.models
    _assert_close(*_frames((jax_bundle, pb), "kl"))
