"""Kernel K3's module (``ops/cuda/taesd_conv.py``) and the port's packed
TAESD routes against the JAX ones (fp32, CPU).

The JAX side runs its Pallas kernel as ``tests/test_models.py`` does, in
interpret mode.  Weights are one sd15-geometry JAX ``taesd_init`` (hidden
64, 3 blocks per stage), with every zero-initialized bias filled with random
values so the kernel's bias epilogue is exercised; they cross through
``state_dict_from_jax``.  Bars: 1e-5 (rtol and atol) for the conv and the
autoencoder, JAX's own bar for its packed routes (``test_models.py``);
``test_golden.py``'s bars (latents atol 5e-4 / rtol 1e-4, image within 1
level) for the frame program.  The CUDA kernel runs only on the card, in
``tests/test_torch_port_kernels_cuda.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from videosd_tpu.models import taesd as JT
from videosd_tpu.ops.pallas import taesd_conv as JK
from videosd_tpu.pipelines import lcm_img2img as J
from videosd_tpu_torch.io import weights as PW
from videosd_tpu_torch.models import taesd as PT
from videosd_tpu_torch.ops.cuda import taesd_conv as K3
from videosd_tpu_torch.pipelines import lcm_img2img as P

# One torch thread per process, set at import: every xdist worker imports
# every test module, and torch threads on every core of every worker stall
# JAX's interpreted Pallas kernels in the worker that runs them.
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
BASE = PT.TAESDConfig()
ROUTES = {"packed": dict(packed_convs=True), "pallas": dict(pallas_convs=True)}


@pytest.fixture(scope="module")
def sd15_taesd():
    params = jax.tree.map(np.asarray, JT.taesd_init(jax.random.PRNGKey(0), JT.TAESDConfig()))
    r = np.random.default_rng(5)

    def fill_biases(node):
        if isinstance(node, dict):
            if "bias" in node:
                node["bias"] = (r.standard_normal(node["bias"].shape) * 0.1).astype(np.float32)
            for v in node.values():
                fill_biases(v)
        elif isinstance(node, list):
            for v in node:
                fill_biases(v)

    fill_biases(params)
    ae = PT.AutoencoderTiny(BASE).eval()
    ae.load_state_dict(PW.state_dict_from_jax(params, PW.taesd_plan(BASE)), strict=True)
    return params, ae


@pytest.fixture(scope="module")
def jax_outputs(sd15_taesd):
    """JAX encode [2,64,96,3] and decode [2,8,12,4] on every route."""
    params, _ = sd15_taesd
    r = np.random.default_rng(6)
    img = r.uniform(-1, 1, (2, 64, 96, 3)).astype(np.float32)
    z = (r.standard_normal((2, 8, 12, 4)) * 3).astype(np.float32)  # past the soft clamp
    out = {}
    for name, kw in {"base": {}, **ROUTES}.items():
        cfg = JT.TAESDConfig(**kw)
        with pltpu.force_tpu_interpret_mode():
            enc = jax.jit(lambda p, a, c=cfg: JT.taesd_encode(p, a, c))(params, img)
            dec = jax.jit(lambda p, a, c=cfg: JT.taesd_decode(p, a, c))(params, z)
        out[name] = (np.asarray(enc), np.asarray(dec))
    return img, z, out


def test_pack2_kernel_matches_jax():
    k = np.random.default_rng(1).standard_normal((3, 3, 64, 64)).astype(np.float32)
    got = PT._pack2_kernel(torch.from_numpy(k)).numpy()
    np.testing.assert_array_equal(got, np.asarray(JT._pack2_kernel(jnp.asarray(k))))


@pytest.mark.parametrize("with_skip", [False, True], ids=["relu", "skip_relu"])
def test_reference_matches_interpreted_kernel(with_skip):
    r = np.random.default_rng(2)
    xp = r.standard_normal((2, 16, 32, 128)).astype(np.float32)
    skip = r.standard_normal(xp.shape).astype(np.float32) if with_skip else None
    kernel = (r.uniform(-1, 1, (3, 3, 64, 64)) / 24.0).astype(np.float32)  # +-1/sqrt(576)
    bias = (r.standard_normal(64) * 0.1).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = JK.packed_conv3x3(
            {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}, jnp.asarray(xp),
            relu=True, skip=None if skip is None else jnp.asarray(skip))
    launches = K3.launches
    got = K3.packed_conv3x3(
        torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()), torch.from_numpy(bias),
        torch.from_numpy(xp), relu=True, skip=None if skip is None else torch.from_numpy(skip))
    assert K3.launches == launches  # CPU tensors never launch the kernel
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert (got.numpy() == 0).mean() > 0.2  # the ReLU is live


@pytest.mark.parametrize("route", list(ROUTES))
def test_sd15_taesd_packed_routes_match_jax(sd15_taesd, jax_outputs, route):
    _, ae = sd15_taesd
    img, z, want = jax_outputs
    cfg = dataclasses.replace(BASE, **ROUTES[route])
    with torch.no_grad():
        enc = PT.taesd_encode(ae, torch.from_numpy(img), cfg).numpy()
        dec = PT.taesd_decode(ae, torch.from_numpy(z), cfg).numpy()
    for got, same, base in ((enc, *[w[0] for w in (want[route], want["base"])]),
                            (dec, *[w[1] for w in (want[route], want["base"])])):
        np.testing.assert_allclose(got, same, **TOL)
        np.testing.assert_allclose(got, base, **TOL)


def test_sd15_taesd_default_route_matches_jax(sd15_taesd, jax_outputs):
    _, ae = sd15_taesd
    img, z, want = jax_outputs
    with torch.no_grad():
        np.testing.assert_allclose(PT.taesd_encode(ae, torch.from_numpy(img)).numpy(),
                                   want["base"][0], **TOL)
        np.testing.assert_allclose(PT.taesd_decode(ae, torch.from_numpy(z)).numpy(),
                                   want["base"][1], **TOL)


@pytest.mark.parametrize("width,packed", [(40, False), (48, True)])
def test_encoder_packs_only_at_widths_of_16(sd15_taesd, monkeypatch, width, packed):
    params, ae = sd15_taesd
    calls = []
    routed = K3.packed_conv3x3
    monkeypatch.setattr(K3, "packed_conv3x3", lambda *a, **k: calls.append(1) or routed(*a, **k))
    img = np.random.default_rng(7).uniform(-1, 1, (1, 16, width, 3)).astype(np.float32)
    cfg = dataclasses.replace(BASE, pallas_convs=True)
    with torch.no_grad():
        got = PT.taesd_encode(ae, torch.from_numpy(img), cfg).numpy()
    assert bool(calls) is packed
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(lambda p, a: JT.taesd_encode(p, a, JT.TAESDConfig(pallas_convs=True)))(
            params, img)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize(
    "shape,routed",
    [
        ((1, 512, 256, 128), True),  # sd15 512^2, C = 64
        ((2, 3, 5, 128), True),  # heights and widths off the TPU's strips
        ((1, 32, 16, 32), False),  # the tiny family, C = 16
        ((16, 32, 128), False),
    ],
)
def test_supports(shape, routed):
    assert K3.supports(shape) is routed


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(1, 16, 8, 128, device="meta", dtype=torch.bfloat16)
    w = torch.zeros(64, 64, 3, 3, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        K3.packed_conv3x3(w, None, x, relu=True)


def test_taps_stay_out_of_the_state_dict(sd15_taesd):
    _, ae = sd15_taesd
    keys = set(ae.state_dict())
    conv = ae.encoder.layers[1].conv[0]
    taps = K3._cached(conv.weight, "_k3_taps", K3._taps)
    assert taps.shape == (9, 64, 64) and taps.dtype == torch.bfloat16
    assert K3._cached(conv.weight, "_k3_taps", K3._taps) is taps  # built once
    assert set(ae.state_dict()) == keys
    with torch.no_grad():
        conv.weight.add_(0.0)  # an in-place write rebuilds the taps
    assert K3._cached(conv.weight, "_k3_taps", K3._taps) is not taps


def _jax_noise(seeds, steps, latent_hw):
    """The JAX program's noise in the port's seam layout [S+1, B, h, w, 4]."""
    return np.stack([
        np.stack([np.asarray(jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(s), k),
                                               (*latent_hw, 4), jnp.float32)) for s in seeds])
        for k in range(steps + 1)
    ])


def test_tiny_program_with_sd15_taesd_pallas_matches_jax(sd15_taesd):
    """The slice as a whole: the tiny 2-step frame program at 64^2, batch 2,
    with its TAESD swapped for the sd15-geometry one on the ``pallas_convs``
    route on both sides."""
    params, ae = sd15_taesd
    cfg = dataclasses.replace(BASE, pallas_convs=True)
    jb = J.ModelBundle.random("tiny", dtype=jnp.float32)  # cached: not mutated
    jb = dataclasses.replace(jb, params={**jb.params, "taesd": params},
                             taesd_cfg=JT.TAESDConfig(pallas_convs=True))
    plans = {
        "unet": PW.unet_plan(P.UNET_PRESETS["tiny"]),
        "controlnet": PW.controlnet_plan(P.UNET_PRESETS["tiny"]),
        "clip": PW.clip_plan(P.CLIP_PRESETS["tiny"]),
    }
    jparams = jax.tree.map(np.asarray, {k: jb.params[k] for k in plans})
    sds = {k: PW.state_dict_from_jax(jparams[k], plan) for k, plan in plans.items()}
    pb = P.ModelBundle.from_state_dicts("tiny", sds, dtype=torch.float32, device="cpu")
    pb = dataclasses.replace(pb, models={**pb.models, "taesd": ae}, taesd_cfg=cfg)

    spec_kw = dict(batch=2, height=64, width=64, steps=2)
    frame = np.random.default_rng(8).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    strength = np.array([0.6, 0.02], np.float32)  # 0.02: one valid step of two
    guidance = np.array([5.0, 3.0], np.float32)
    cn_scale = np.array([2.0, 0.5], np.float32)
    seeds = np.array([23, 7], np.int32)
    ids = jb.tokenizer(["a portrait", "a landscape"])
    jemb, _ = J.build_prompt_encoder(jb)(jb.params, jnp.asarray(ids, jnp.int32))
    with pltpu.force_tpu_interpret_mode():
        jimg, jlat = J.build_frame_program(jb, J.FrameSpec(**spec_kw))(
            jb.params, jnp.asarray(frame), jemb, jnp.asarray(strength), jnp.asarray(guidance),
            jnp.asarray(cn_scale), jnp.asarray(seeds))
    pemb, _ = P.build_prompt_encoder(pb)(ids)
    pimg, plat = P.build_frame_program(pb, P.FrameSpec(**spec_kw))(
        frame, pemb, strength, guidance, cn_scale, seeds,
        noise=_jax_noise(seeds.tolist(), 2, (8, 8)))
    np.testing.assert_allclose(plat.numpy(), np.asarray(jlat), atol=5e-4, rtol=1e-4)
    assert np.abs(pimg.numpy().astype(int) - np.asarray(jimg).astype(int)).max() <= 1
