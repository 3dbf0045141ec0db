"""The port's KL VAE (``models/vae.py``), its tiling (``ops/tiling.py``) and
the KL frame program against the JAX package (fp32, CPU).

Weights cross from JAX ``vae_init`` trees through ``state_dict_from_jax``
with the port's ``vae_plan``; inputs come from a numpy seed.  On the CPU
the mid attention takes K1's plain version, the ``_attention_xla`` math.

* ``vae_encode`` (mode and sample) and ``vae_decode``, at the tiny family's
  widths at 128x128 (the mid attention at S = 256, d = 16: the shape JAX
  routes to its flash kernel) and at sd15's widths at 64x64 (d = 512):
  within 1e-4 of the largest output (fp32 on both sides, sums in other
  orders).  Sample mode takes JAX's normals through the ``noise`` seam.
* The KL frame program of one tiny JAX bundle with a KL VAE, at the frame
  program's bars (latents atol 5e-4 / rtol 1e-4, image within 1 level):
  parity, the warm start with a crop box and temporal DeepCache, and the
  staged program over two calls; its body on ``meta`` under the capture
  guard of ``test_torch_port_graph_program.py``.
* ``_latent_hw`` against the encoded shapes where KL and TAESD differ.
* ``tiled_decode`` and ``tiled_encode`` over grids of overlapping tiles.
No interpreted Pallas kernel runs here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videosd_tpu.models import vae as JV
from videosd_tpu.models.taesd import taesd_encode as j_taesd_encode
from videosd_tpu.ops import tiling as JT
from videosd_tpu.pipelines import lcm_img2img as J
from videosd_tpu_torch.io import weights as PW
from videosd_tpu_torch.models import vae as PV
from videosd_tpu_torch.ops import tiling as PT
from videosd_tpu_torch.pipelines import lcm_img2img as P

from test_torch_port_graph_program import capture_guard

# one torch thread per process (see tests/test_torch_port_production.py)
torch.set_num_threads(1)

VAE_REL = 1e-4
LAT_ATOL, LAT_RTOL, IMG_LEVELS = 5e-4, 1e-4, 1
B = 2
ARGS = (np.array([0.9, 0.7], np.float32), np.array([5.0, 3.0], np.float32),
        np.array([2.0, 0.5], np.float32), np.array([23, 7], np.int32))


def _jax_cfg(family):
    if family == "tiny":
        return JV.VAEConfig(block_out_channels=(8, 16, 16, 16), layers_per_block=1,
                            norm_num_groups=4)
    return JV.VAEConfig()


@pytest.fixture(scope="module", params=["tiny", "sd15"])
def vaes(request):
    """(family, JAX params, JAX config, port model) of one family's VAE,
    with random biases and group-norm affines on both sides (zero at init,
    where a wrong bias or norm path would not show)."""
    family = request.param
    jcfg = _jax_cfg(family)
    params = jax.tree.map(np.asarray, JV.vae_init(jax.random.PRNGKey(3), jcfg))
    rng = np.random.default_rng(4)

    def perturb(path, a):
        if path[-1].key in ("bias", "scale"):
            base = 1.0 if path[-1].key == "scale" else 0.0
            return (base + rng.normal(0, 0.1, a.shape)).astype(np.float32)
        return a

    params = jax.tree_util.tree_map_with_path(perturb, params)
    cfg = PV.VAE_PRESETS[family]
    model = PV.AutoencoderKL(cfg).eval().requires_grad_(False)
    model.load_state_dict(PW.state_dict_from_jax(params, PW.vae_plan(cfg)), strict=True)
    return family, jax.tree.map(jnp.asarray, params), jcfg, model


def _side(family):
    return 128 if family == "tiny" else 64


def _assert_rel(got, want, rel=VAE_REL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


def test_encode_matches_jax(vaes):
    family, jparams, jcfg, model = vaes
    side = _side(family)
    x = np.random.default_rng(0).uniform(-1, 1, (1, side, side, 3)).astype(np.float32)
    want = JV.vae_encode(jparams, jnp.asarray(x), jcfg)
    with torch.inference_mode():
        got = PV.vae_encode(model, torch.from_numpy(x))
    assert got.shape == (1, side // 8, side // 8, 4)
    _assert_rel(got, want)


def test_decode_matches_jax(vaes):
    family, jparams, jcfg, model = vaes
    side = _side(family) // 8
    z = np.random.default_rng(1).standard_normal((1, side, side, 4)).astype(np.float32)
    want = JV.vae_decode(jparams, jnp.asarray(z), jcfg)
    with torch.inference_mode():
        got = PV.vae_decode(model, torch.from_numpy(z))
    assert got.shape == (1, 8 * side, 8 * side, 3)
    _assert_rel(got, want)


def test_sample_mode_matches_jax_with_its_noise(vaes):
    """Sample mode: JAX draws normal(key) of the mean's shape in fp32; the
    port takes those normals through ``noise``, and with a generator draws
    its own (other values, the same shape and dtype)."""
    family, jparams, jcfg, model = vaes
    side = _side(family)
    x = np.random.default_rng(2).uniform(-1, 1, (B, side, side, 3)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = JV.vae_encode(jparams, jnp.asarray(x), jcfg, key=key, sample=True)
    noise = np.array(jax.random.normal(key, want.shape, jnp.float32))
    with torch.inference_mode():
        got = PV.vae_encode(model, torch.from_numpy(x), sample=True,
                            noise=torch.from_numpy(noise))
        drawn = PV.vae_encode(model, torch.from_numpy(x), sample=True,
                              generator=torch.Generator().manual_seed(0))
    _assert_rel(got, want)
    assert drawn.shape == got.shape and drawn.dtype == got.dtype
    with pytest.raises(ValueError, match="generator or noise"):
        PV.vae_encode(model, torch.from_numpy(x), sample=True)


# ---------------------------------------------------------------- the frame program


@pytest.fixture(scope="module")
def bundles():
    """One tiny JAX bundle with a KL VAE (random biases in the VAE, the
    ControlNet's zeroed output convs perturbed) crossed to the port."""
    jb = J.ModelBundle.random("tiny", dtype=jnp.float32, with_kl_vae=True)
    params = jax.tree.map(np.asarray, jb.params)
    rng = np.random.default_rng(3)
    cn = dict(params["controlnet"])
    for name in ("controlnet_down_blocks", "controlnet_mid_block"):
        cn[name] = jax.tree.map(lambda a: rng.normal(0, 0.05, a.shape).astype(np.float32),
                                cn[name])
    params["controlnet"] = cn
    params["vae"] = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.normal(0, 0.1, a.shape).astype(np.float32)
                         if path[-1].key == "bias" else a), params["vae"])
    plans = {
        "unet": PW.unet_plan(P.UNET_PRESETS["tiny"]),
        "controlnet": PW.controlnet_plan(P.UNET_PRESETS["tiny"]),
        "clip": PW.clip_plan(P.CLIP_PRESETS["tiny"]),
        "taesd": PW.taesd_plan(jb.taesd_cfg),
        "vae": PW.vae_plan(PV.VAE_PRESETS["tiny"]),
    }
    sds = {k: PW.state_dict_from_jax(params[k], plan) for k, plan in plans.items()}
    pb = P.ModelBundle.from_state_dicts("tiny", sds, dtype=torch.float32, device="cpu")
    jparams = jax.tree.map(jnp.asarray, params)
    ids = jnp.asarray(jb.tokenizer(["a portrait", "a landscape"]), jnp.int32)
    emb, _ = J.build_prompt_encoder(jb)(jparams, ids)
    return jb, jparams, pb, np.array(emb)


def _jax_noise(seeds, steps, latent_hw):
    return np.stack([
        np.stack([np.asarray(jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(s), k),
                                               (*latent_hw, 4), jnp.float32)) for s in seeds])
        for k in range(steps + 1)
    ])


def _run_jax(bundles, spec_kw, frame, **kw):
    jb, jparams, _, emb = bundles
    out = J.frame_program(
        jparams, J.FrameSpec(**spec_kw), jb.unet_cfg, jb.sched_cfg, jb.taesd_cfg, jb.vae_cfg,
        jb.alphas_cumprod, jb.dtype, jnp.asarray(frame), jnp.asarray(emb),
        *(jnp.asarray(a) for a in ARGS), **{k: jnp.asarray(v) for k, v in kw.items()},
    )
    return [np.asarray(o) for o in out]


def _assert_close(port, ref):
    assert len(port) == len(ref)
    img, lat, *caches = (o.numpy() for o in port)
    assert img.dtype == np.uint8 and img.shape == ref[0].shape
    assert np.abs(img.astype(int) - ref[0].astype(int)).max() <= IMG_LEVELS
    for got, want in zip([lat, *caches], ref[1:]):
        np.testing.assert_allclose(got, want, atol=LAT_ATOL, rtol=LAT_RTOL)


def _frames(hw, seed):
    return np.random.default_rng(seed).integers(0, 256, (B, *hw, 3), dtype=np.uint8)


def _mailbox(seed=11):
    """Two camera frames in 96x96 mailboxes, with the boxes of a 64x64 crop."""
    rng = np.random.default_rng(seed)
    mail = np.zeros((B, 96, 96, 3), np.uint8)
    mail[0, :72, :96] = rng.integers(0, 256, (72, 96, 3), dtype=np.uint8)
    mail[1, :96, :60] = rng.integers(0, 256, (96, 60, 3), dtype=np.uint8)
    return mail, np.array([[4, 16, 64, 64], [16, 0, 64, 60]], np.int32)


# (spec fields, frame, call kwargs) per call, all through one program
KL_CASES = {
    "parity": [({"steps": 2}, "rgb", {})],
    "warm_start_src_box_temporal": [
        ({"steps": 2, "in_height": 96, "in_width": 96, "deepcache_temporal": True}, "mailbox",
         "warm"),
        ({"steps": 2, "in_height": 96, "in_width": 96, "deepcache_temporal": True}, "mailbox",
         "warm_reuse"),
    ],
}


@pytest.mark.parametrize("case", list(KL_CASES))
def test_kl_frame_program_matches_jax(bundles, case):
    """The KL frame program of ``build_frame_program`` against JAX's
    ``frame_program`` with ``vae="kl"`` at 64x64 (8x8 latents): parity, and
    the engine's variant (a crop box in a mailbox, the warm start, temporal
    DeepCache produce then reuse of JAX's caches)."""
    pb, emb = bundles[2], torch.from_numpy(bundles[3])
    calls = KL_CASES[case]
    base = {"batch": B, "height": 64, "width": 64, "vae": "kl"}
    program = P.build_frame_program(pb, P.FrameSpec(**base, **calls[0][0]))
    warm = np.random.default_rng(9).standard_normal((B, 8, 8, 4)).astype(np.float32)
    caches = None
    for spec_kw, kind, kw in calls:
        frame = _frames((64, 64), 5) if kind == "rgb" else _mailbox()[0]
        if kw in ("warm", "warm_reuse"):
            kw = {"src_box": _mailbox()[1], "warm_latents": warm,
                  "warm_alpha": np.array([0.3, 0.6], np.float32),
                  **({"deep_caches": caches} if kw == "warm_reuse" else {})}
        ref = _run_jax(bundles, {**base, **spec_kw}, frame, **kw)
        port = program(frame, emb, *ARGS, noise=_jax_noise(ARGS[3].tolist(), spec_kw["steps"],
                                                          (8, 8)),
                       **{k: torch.from_numpy(np.array(v)) for k, v in kw.items()})
        _assert_close(port, ref)
        if len(ref) == 3:
            caches = ref[2]
    assert len(program.buckets) == len(calls)


def test_kl_staged_program_keeps_each_calls_results(bundles):
    """Two KL calls of one signature in a row: each equals the eager
    ``frame_program`` of its own inputs bit for bit, on the same static
    buffers, and the first call's tensors survive the second."""
    pb, emb = bundles[2], torch.from_numpy(bundles[3])
    spec = P.FrameSpec(batch=B, height=64, width=64, steps=2, vae="kl")
    program = P.build_frame_program(pb, spec)
    outs, wants, kept, pointers = [], [], [], []
    for seed in (31, 32):
        args = (*ARGS[:3], np.array([seed, seed + 100], np.int32))
        outs.append(program(_frames((64, 64), seed), emb, *args))
        kept.append([o.clone() for o in outs[-1]])
        wants.append(P.frame_program(pb, spec, _frames((64, 64), seed), emb, *args))
        (bucket,) = program.buckets.values()
        pointers.append({k: v.data_ptr() for k, v in bucket.buffers.items() if v is not None})
    assert pointers[0] == pointers[1]
    for out, want, snap in zip(outs, wants, kept):
        assert all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(out, want, snap))
    assert not torch.equal(outs[0][1], outs[1][1])


def test_kl_body_makes_no_host_copy_or_sync():
    """The KL bucket's body on meta buffers under the capture guard: the
    scaling factor's multiply and division are filled on the device."""
    meta = P.ModelBundle.random("tiny", dtype=torch.float32, device="meta", with_kl_vae=True)
    spec = P.FrameSpec(batch=B, height=64, width=64, steps=2, vae="kl")
    inputs = P._call_inputs(meta, spec, _frames((64, 64), 0), np.zeros((B, 77, 32), np.float32),
                            *ARGS[:3], None, None, None, None, None, None)
    bufs = P._new_buffers(meta, spec, inputs)
    with torch.inference_mode():
        warm = P._frame_body(meta, spec, **bufs)
        with capture_guard():
            out = P._frame_body(meta, spec, **bufs)
    assert [tuple(o.shape) for o in out] == [tuple(o.shape) for o in warm]
    assert out[0].shape == (B, 64, 64, 3) and out[1].shape == (B, 8, 8, 4)


def test_kl_spec_needs_a_vae(bundles):
    pb = bundles[2]
    no_vae = dataclasses.replace(pb, models={k: m for k, m in pb.models.items() if k != "vae"})
    with pytest.raises(ValueError, match="KL VAE"):
        P.build_frame_program(no_vae, P.FrameSpec(height=64, width=64, vae="kl"))
    with pytest.raises(ValueError, match="taesd or kl"):
        P.build_frame_program(pb, P.FrameSpec(height=64, width=64, vae="sdxl"))


@pytest.mark.parametrize("side", [36, 64, 100])
def test_latent_hw_follows_the_vae(bundles, side):
    """The KL encoder rounds a side down (36 -> 4), TAESD rounds it up
    (36 -> 5): the port's latent shape is JAX's encoded shape for each."""
    jb, jparams, pb, _ = bundles
    x = jnp.zeros((1, side, side, 3), jnp.float32)
    kl = JV.vae_encode(jparams["vae"], x, jb.vae_cfg).shape[1:3]
    taesd = j_taesd_encode(jparams["taesd"], x, jb.taesd_cfg).shape[1:3]
    assert P._latent_hw(pb, P.FrameSpec(height=side, width=side, vae="kl")) == tuple(kl)
    assert P._latent_hw(pb, P.FrameSpec(height=side, width=side)) == tuple(taesd)
    with torch.inference_mode():
        assert tuple(PV.vae_encode(pb.models["vae"], torch.zeros(1, side, side, 3)).shape[1:3]) \
            == tuple(kl)
    if side == 36:
        assert (kl[0], taesd[0]) == (4, 5)


# ---------------------------------------------------------------- tiling


def test_tiled_decode_matches_jax(bundles):
    """A 20x20 latent grid in 8-latent tiles overlapping by 2: 3x3 tiles."""
    jb, jparams, pb, _ = bundles
    z = np.random.default_rng(6).standard_normal((1, 20, 20, 4)).astype(np.float32)
    want = JT.tiled_decode(lambda t: JV.vae_decode(jparams["vae"], t, jb.vae_cfg),
                           jnp.asarray(z), tile=8, overlap=2)
    with torch.inference_mode():
        got = PT.tiled_decode(lambda t: PV.vae_decode(pb.models["vae"], t),
                              torch.from_numpy(z), tile=8, overlap=2)
    assert got.dtype == torch.float32
    _assert_rel(got, want)


def test_tiled_encode_matches_jax(bundles):
    """A 160x136 image in 64-pixel tiles overlapping by 16: 3x3 tiles, the
    last of each axis flush with the edge."""
    jb, jparams, pb, _ = bundles
    x = np.random.default_rng(7).uniform(-1, 1, (2, 160, 136, 3)).astype(np.float32)
    want = JT.tiled_encode(lambda t: JV.vae_encode(jparams["vae"], t, jb.vae_cfg),
                           jnp.asarray(x), tile=64, overlap=16)
    with torch.inference_mode():
        got = PT.tiled_encode(lambda t: PV.vae_encode(pb.models["vae"], t),
                              torch.from_numpy(x), tile=64, overlap=16)
    assert got.shape == (2, 20, 17, 4)
    _assert_rel(got, want)


def test_tiling_passes_a_single_tile_through(bundles):
    _, _, pb, _ = bundles
    z = torch.from_numpy(np.random.default_rng(8).standard_normal((1, 8, 8, 4)).astype(np.float32))
    with torch.inference_mode():
        direct = PV.vae_decode(pb.models["vae"], z)
        assert torch.equal(PT.tiled_decode(lambda t: PV.vae_decode(pb.models["vae"], t), z,
                                           tile=8), direct)
