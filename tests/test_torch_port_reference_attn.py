"""The port's reference-attention program against the JAX one (fp32, CPU).

Counterparts of ``tests/test_reference_attn.py``'s cases on the tiny
family (its SDXL case waits for the SDXL family), each held against the
JAX program: weights cross from one JAX ``ModelBundle.random("tiny")``
through ``state_dict_from_jax``, and the port takes JAX's noise through
its seam (rows ``fold_in(key, k)`` for k = 0..S and the reference's
``fold_in(key, 10_000)``).  Bar: latents 1e-4 relative (absolute floor
1e-4), images within one level.  Plus a case that holds the AdaIN
statistics to the population variance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videosd_tpu.pipelines import lcm_img2img as J
from videosd_tpu.pipelines import reference_attn as JR
from videosd_tpu_torch.io import weights as PW
from videosd_tpu_torch.pipelines import lcm_img2img as P
from videosd_tpu_torch.pipelines import reference_attn as R

# One torch thread per process, set at import: every xdist worker imports
# every test module, and torch threads on every core of every worker stall
# JAX's interpreted Pallas kernels in the worker that runs them.
torch.set_num_threads(1)

SPEC_KW = dict(batch=1, height=32, width=32, steps=2, use_controlnet=False)
SEED = 23
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def bundles():
    # built afresh (a test earlier in this process may have swapped the
    # cached bundle's weights)
    cached = J.ModelBundle._random_cache
    J.ModelBundle._random_cache = {}
    try:
        jb = J.ModelBundle.random("tiny", dtype=jnp.float32, with_controlnet=False)
    finally:
        J.ModelBundle._random_cache = cached
    params = jax.tree.map(np.asarray, jb.params)
    plans = {"unet": PW.unet_plan(P.UNET_PRESETS["tiny"]),
             "clip": PW.clip_plan(P.CLIP_PRESETS["tiny"]),
             "taesd": PW.taesd_plan(jb.taesd_cfg)}
    sds = {k: PW.state_dict_from_jax(params[k], plan) for k, plan in plans.items()}
    pb = P.ModelBundle.from_state_dicts("tiny", sds, dtype=torch.float32, device="cpu")
    ids = jb.tokenizer(["style"])
    jemb = J.build_prompt_encoder(jb)(jb.params, jnp.asarray(ids, jnp.int32))[0]
    pemb = P.build_prompt_encoder(pb)(ids)[0]
    np.testing.assert_allclose(pemb.numpy(), np.asarray(jemb), atol=1e-5, rtol=1e-4)
    jprog = JR.build_reference_program(jb, J.FrameSpec(**SPEC_KW))
    return jb, jemb, jprog, pb, pemb, {}


def _noise(seed, steps, hw=(4, 4)):
    key = jax.random.PRNGKey(seed)

    def draw(k):
        return np.array(jax.random.normal(jax.random.fold_in(key, k), (*hw, 4), jnp.float32))

    return (np.stack([draw(k)[None] for k in range(steps + 1)]), draw(10_000)[None])


_RNG = np.random.default_rng(0)
FRAME = _RNG.integers(0, 256, (1, 32, 32, 3), dtype=np.uint8)
REF = _RNG.integers(0, 256, (1, 32, 32, 3), dtype=np.uint8)
LOUD = np.full((1, 32, 32, 3), 255, np.uint8)


def _jax_out(bundles, ref, sf2):
    """The JAX program's outputs, cached per (reference, fidelity pair)."""
    jb, jemb, jprog, _, _, cache = bundles
    key = (ref.tobytes(), sf2)
    if key not in cache:
        out, lat = jprog(jb.params, jnp.asarray(FRAME), jnp.asarray(ref), jemb,
                         jnp.array([0.6], jnp.float32), jnp.array([5.0], jnp.float32),
                         jnp.asarray([sf2], jnp.float32), jnp.array([SEED], jnp.int32))
        cache[key] = np.asarray(out), np.asarray(lat)
    return cache[key]


def _run(bundles, ref_name, sf):
    """The port program at ``sf`` (a float: the [B] form; a pair: [B, 2])
    beside the JAX program (always the [B, 2] form: one compile; a [B] sf is
    both columns equal), both on JAX's noise; returns the port's outputs."""
    pb, pemb = bundles[3:5]
    sf2 = tuple(sf) if isinstance(sf, tuple) else (sf, sf)
    psf = np.asarray([sf2 if isinstance(sf, tuple) else sf], np.float32)
    ref = {"ref": REF, "loud": LOUD}[ref_name]
    noise, ref_noise = _noise(SEED, SPEC_KW["steps"])
    img, lat = R.build_reference_program(pb, P.FrameSpec(**SPEC_KW))(
        FRAME, ref, pemb, [0.6], [5.0], psf, [SEED], noise, ref_noise)
    jimg, jlat = _jax_out(bundles, ref, sf2)
    np.testing.assert_allclose(lat.numpy(), jlat, **TOL)
    assert np.abs(img.numpy().astype(int) - jimg.astype(int)).max() <= 1
    return img.numpy(), lat.numpy()


def test_adain_bank_write_read_roundtrip(rng):
    x = rng.standard_normal((1, 4, 4, 8)).astype(np.float32)
    y = (rng.standard_normal((1, 4, 4, 8)) * 3 + 2).astype(np.float32)
    nchw = [torch.from_numpy(a).permute(0, 3, 1, 2) for a in (x, y)]
    w = R.AdainBank("write")
    assert w(nchw[0]) is nchw[0] and len(w.stats) == 1
    jw = JR.AdainBank("write")
    jw(jnp.asarray(x))
    for got, want in zip(w.stats[0], jw.stats[0]):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), **TOL)
    # reading its own statistics at fidelity 1 is the identity
    r = R.AdainBank("read", stats=w.stats, fidelity=1.0)
    np.testing.assert_allclose(r(nchw[0]).numpy(), nchw[0].numpy(), atol=1e-5)
    # reading another's statistics moves the activations to them, as JAX does
    w2, jw2 = R.AdainBank("write"), JR.AdainBank("write")
    w2(nchw[1])
    jw2(jnp.asarray(y))
    fid = np.array([0.7], np.float32)
    got = R.AdainBank("read", stats=w2.stats, fidelity=torch.from_numpy(fid)[:, None, None, None])
    want = JR.AdainBank("read", stats=jw2.stats, fidelity=jnp.asarray(fid)[:, None, None, None])
    out = got(nchw[0])
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(want(jnp.asarray(x))),
                               **TOL)
    full = R.AdainBank("read", stats=w2.stats, fidelity=1.0)(nchw[0]).numpy()
    np.testing.assert_allclose(full.mean(axis=(2, 3)), y.mean(axis=(1, 2)), atol=1e-4)


def test_adain_statistics_use_the_population_variance():
    """On a 2x2 grid the unbiased variance is 4/3 of the population one:
    torch.var's default would miss JAX's jnp.var (ddof = 0) by far more
    than the bar."""
    x = np.arange(2 * 3 * 2 * 2, dtype=np.float32).reshape(2, 3, 2, 2) ** 1.5
    w = R.AdainBank("write")
    w(torch.from_numpy(x))
    _, std = w.stats[0]
    want = np.sqrt(x.reshape(2, 3, 4).var(axis=-1, ddof=0) + 1e-5)
    np.testing.assert_allclose(std[:, :, 0, 0].numpy(), want, rtol=1e-6)
    jw = JR.AdainBank("write")
    jw(jnp.asarray(x.transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(std[:, :, 0, 0].numpy(), np.asarray(jw.stats[0][1])[:, 0, 0],
                               rtol=1e-6)
    unbiased = np.sqrt(x.reshape(2, 3, 4).var(axis=-1, ddof=1) + 1e-5)
    assert np.abs(unbiased / want - 1).min() > 0.1


def test_reference_program_end_to_end(bundles):
    img, lat = _run(bundles, "ref", 1.0)
    assert img.shape == (1, 32, 32, 3) and img.dtype == np.uint8
    assert np.isfinite(lat).all()
    # determinism: the same call again is bit for bit the same
    pb, pemb = bundles[3:5]
    noise, ref_noise = _noise(SEED, SPEC_KW["steps"])
    prog = R.build_reference_program(pb, P.FrameSpec(**SPEC_KW))
    a = prog(FRAME, REF, pemb, [0.6], [5.0], [1.0], [SEED], noise, ref_noise)
    b = prog(FRAME, REF, pemb, [0.6], [5.0], [1.0], [SEED], noise, ref_noise)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    np.testing.assert_array_equal(a[1].numpy(), lat)


def test_reference_image_influences_output(bundles):
    out_a, _ = _run(bundles, "ref", 1.0)
    out_b, _ = _run(bundles, "loud", 1.0)
    assert np.abs(out_a.astype(int) - out_b.astype(int)).max() > 0


def test_style_fidelity_zero_equals_the_plain_program(bundles):
    """sf = 0 is the plain (no-ControlNet) frame program bit for bit on the
    CPU, on the same noise."""
    pb, pemb = bundles[3:5]
    img, lat = _run(bundles, "loud", 0.0)
    noise, _ = _noise(SEED, SPEC_KW["steps"])
    pimg, plat = P.build_frame_program(pb, P.FrameSpec(**SPEC_KW))(
        FRAME, pemb, [0.6], [5.0], [2.0], [SEED], noise=noise)
    np.testing.assert_array_equal(img, pimg.numpy())
    np.testing.assert_array_equal(lat, plat.numpy())


def test_style_fidelity_interpolates_monotonically(bundles):
    outs = {sf: _run(bundles, "loud", sf)[0].astype(np.float64) for sf in (0.0, 0.33, 0.66, 1.0)}
    d = [np.abs(outs[sf] - outs[0.0]).mean() for sf in (0.33, 0.66, 1.0)]
    assert d[0] > 0
    assert d[0] < d[1] < d[2], d


def test_independent_attn_adain_toggles(bundles):
    """style_fidelity [B, 2] = (attention, AdaIN): each mechanism alone moves
    the output, differently; both off is the [B] form at 0, both on the [B]
    form at 1."""
    run = {pair: _run(bundles, "loud", pair)[0].astype(np.float64)
           for pair in ((0.0, 0.0), (1.0, 0.0), (0.0, 1.0), (1.0, 1.0))}
    np.testing.assert_array_equal(run[(0.0, 0.0)], _run(bundles, "loud", 0.0)[0])
    np.testing.assert_array_equal(run[(1.0, 1.0)], _run(bundles, "loud", 1.0)[0])
    assert np.abs(run[(1.0, 0.0)] - run[(0.0, 0.0)]).max() > 0
    assert np.abs(run[(0.0, 1.0)] - run[(0.0, 0.0)]).max() > 0
    assert np.abs(run[(1.0, 0.0)] - run[(0.0, 1.0)]).max() > 0


def test_warmup_ref_warms_the_ref_bucket():
    """Engine.warmup(ref=True) also warms each bucket's reference program,
    whose spec mirrors the batcher's ref coercions (no ControlNet, intervals
    1, no temporal cache); the plain bucket is warmed too."""
    from videosd_tpu_torch.runtime.engine import Engine

    bundle = P.ModelBundle.random("tiny", dtype=torch.float32, device="cpu")
    eng = Engine(bundle=bundle, max_streams=1, max_batch=1, deadline_ms=5, frame_hw=(64, 64))
    eng.warmup(batch_sizes=(1,), steps=(2,), height=64, width=64, ref=True)
    ref_specs = [sp for sp, rm in eng._ready_specs if rm]
    assert ref_specs, eng._ready_specs
    assert all(not sp.use_controlnet and sp.controlnet_interval == 1
               and sp.deepcache_interval == 1 and not sp.deepcache_temporal
               for sp in ref_specs)
    assert any(not rm for _sp, rm in eng._ready_specs)
    assert isinstance(eng._programs[(ref_specs[0], True)], R.ReferenceProgram)
