"""The port's tiny frame program against the JAX one (fp32, CPU).

Weights cross from one JAX ``ModelBundle.random("tiny")`` through
``state_dict_from_jax``; the port is fed JAX's own noise through its noise
seam, since torch generators do not reproduce threefry bits.

* Against the golden fixture, with ``test_golden.py``'s inputs and bars
  (latents atol 5e-4 / rtol 1e-4, image within 1 level).
* Against a live batch-2 JAX run with per-element settings, one element
  of which has a single valid step (the masked ladder): same bars.  Both
  sides run the same fp32 math on the CPU; the bars absorb reduction-order
  differences between XLA and torch.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videosd_tpu.pipelines import lcm_img2img as J
from videosd_tpu_torch.io import weights as PW
from videosd_tpu_torch.pipelines import lcm_img2img as P

# One torch thread per process, set at import: every xdist worker imports
# every test module, and torch threads on every core of every worker stall
# JAX's interpreted Pallas kernels in the worker that runs them.
torch.set_num_threads(1)

_FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "golden_tiny_2step.npz")


@pytest.fixture(scope="module")
def bundles():
    # built afresh, not taken from ModelBundle.random's per-process cache:
    # the golden fixture holds the init values, and a test that ran earlier
    # in this process may have swapped the cached bundle's weights
    # (test_runtime.py::test_engine_live_weight_swap does)
    cached = J.ModelBundle._random_cache
    J.ModelBundle._random_cache = {}
    try:
        jb = J.ModelBundle.random("tiny", dtype=jnp.float32)
    finally:
        J.ModelBundle._random_cache = cached
    params = jax.tree.map(np.asarray, jb.params)
    plans = {
        "unet": PW.unet_plan(P.UNET_PRESETS["tiny"]),
        "controlnet": PW.controlnet_plan(P.UNET_PRESETS["tiny"]),
        "clip": PW.clip_plan(P.CLIP_PRESETS["tiny"]),
        "taesd": PW.taesd_plan(jb.taesd_cfg),
    }
    sds = {k: PW.state_dict_from_jax(params[k], plan) for k, plan in plans.items()}
    return jb, P.ModelBundle.from_state_dicts("tiny", sds, dtype=torch.float32, device="cpu")


def _jax_noise(seeds, steps, latent_hw):
    """The JAX program's noise: row k of element b is
    normal(fold_in(PRNGKey(seed_b), k)) -- the port's seam layout."""
    rows = []
    for k in range(steps + 1):
        rows.append(
            np.stack(
                [
                    np.asarray(
                        jax.random.normal(
                            jax.random.fold_in(jax.random.PRNGKey(s), k),
                            (*latent_hw, 4),
                            jnp.float32,
                        )
                    )
                    for s in seeds
                ]
            )
        )
    return np.stack(rows)


def _port_embeds(pb, prompts):
    ids = pb.tokenizer(prompts)
    embeds, _ = P.build_prompt_encoder(pb)(ids)
    return embeds


def test_port_tiny_program_matches_golden(bundles):
    _, pb = bundles
    golden = np.load(_FIXTURE)
    spec = P.FrameSpec(batch=1, height=32, width=32, in_height=32, in_width=32, steps=2)
    frame = np.random.default_rng(1234).integers(0, 256, (1, 32, 32, 3), dtype=np.uint8)
    noise = _jax_noise([23], spec.steps, (4, 4))
    img, lat = P.build_frame_program(pb, spec)(
        frame, _port_embeds(pb, ["golden prompt"]), [0.6], [5.0], [2.0], [23], noise=noise
    )
    np.testing.assert_allclose(lat.numpy(), golden["latents"], atol=5e-4, rtol=1e-4)
    assert np.abs(img.numpy().astype(int) - golden["image"].astype(int)).max() <= 1


def test_port_tiny_program_matches_live_jax_batch2(bundles):
    jb, pb = bundles
    spec_kw = dict(batch=2, height=32, width=32, steps=2)
    frame = np.random.default_rng(5).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    strength = np.array([0.6, 0.02], np.float32)  # 0.02: one valid step of two
    guidance = np.array([5.0, 3.0], np.float32)
    cn_scale = np.array([2.0, 0.5], np.float32)
    seeds = np.array([23, 7], np.int32)
    prompts = ["a portrait", "a landscape"]

    jids = jnp.asarray(jb.tokenizer(prompts), jnp.int32)
    jemb, _ = J.build_prompt_encoder(jb)(jb.params, jids)
    jimg, jlat = J.build_frame_program(jb, J.FrameSpec(**spec_kw))(
        jb.params, jnp.asarray(frame), jemb, jnp.asarray(strength), jnp.asarray(guidance),
        jnp.asarray(cn_scale), jnp.asarray(seeds),
    )
    pemb = _port_embeds(pb, prompts)
    np.testing.assert_allclose(pemb.numpy(), np.asarray(jemb), atol=1e-5, rtol=1e-4)
    pimg, plat = P.build_frame_program(pb, P.FrameSpec(**spec_kw))(
        frame, pemb, strength, guidance, cn_scale, seeds,
        noise=_jax_noise(seeds.tolist(), 2, (4, 4)),
    )
    np.testing.assert_allclose(plat.numpy(), np.asarray(jlat), atol=5e-4, rtol=1e-4)
    assert np.abs(pimg.numpy().astype(int) - np.asarray(jimg).astype(int)).max() <= 1


def test_port_program_rejects_unported_spec_fields(bundles):
    _, pb = bundles
    # vae="kl" is ported; this bundle was built without a KL VAE
    with pytest.raises(ValueError, match="KL VAE"):
        P.build_frame_program(pb, P.FrameSpec(height=32, width=32, vae="kl"))
    with pytest.raises(ValueError, match="mutually exclusive"):
        P.build_frame_program(pb, P.FrameSpec(height=32, width=32, deepcache_temporal=True,
                                              deepcache_interval=2))
    prog = P.build_frame_program(pb, P.FrameSpec(height=32, width=32, steps=2))
    frame = np.zeros((1, 32, 32, 3), np.uint8)
    emb = torch.zeros(1, 77, 32)
    # SDXL's pooled_embeds is ignored by a bundle without text_time, as in JAX:
    # the same signature, the same result
    plain = prog(frame, emb, [0.5], [1.0], [1.0], [0])
    pooled = prog(frame, emb, [0.5], [1.0], [1.0], [0], pooled_embeds=torch.zeros(1, 32))
    assert len(prog.buckets) == 1
    assert all(torch.equal(a, b) for a, b in zip(plain, pooled))
