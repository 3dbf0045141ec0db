"""The staged frame program of ``build_frame_program`` (CPU, fp32).

``build_frame_program`` returns a program that keeps static device buffers
per call signature, stages each call's inputs into them and runs the body
over them: on a CUDA bundle by replaying the CUDA graph captured at the
signature's first call, here on the CPU eagerly over the same buffers.
These tests hold that path against JAX's ``frame_program`` at
``test_golden.py``'s bars (latents atol 5e-4 / rtol 1e-4, image within 1
level), show that consecutive calls neither read stale buffers nor share
their outputs, and stand in for the capture, which needs the card: the
body runs on the ``meta`` device under a guard that fails on any host copy
or host sync, the two things a CUDA graph cannot capture.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from videosd_tpu.ops.preprocess import center_crop_box, rgb_to_i420_host
from videosd_tpu.pipelines import lcm_img2img as J
from videosd_tpu_torch.io import weights as PW
from videosd_tpu_torch.ops.sobel import div_rn
from videosd_tpu_torch.pipelines import lcm_img2img as P
from videosd_tpu_torch.pipelines import safety as PS

# one torch thread per process (see tests/test_torch_port_production.py)
torch.set_num_threads(1)

LAT_ATOL, LAT_RTOL, IMG_LEVELS = 5e-4, 1e-4, 1
B = 2
ARGS = (np.array([0.9, 0.7], np.float32), np.array([5.0, 3.0], np.float32),
        np.array([2.0, 0.5], np.float32), np.array([23, 7], np.int32))


@pytest.fixture(scope="module")
def bundles():
    """The tiny JAX bundle crossed to the port, with the ControlNet's
    zero-initialized output convs perturbed alike on both sides (at zero the
    interval variants could not be told apart)."""
    jb = J.ModelBundle.random("tiny", dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jb.params)
    cn = dict(params["controlnet"])
    prng = np.random.default_rng(3)

    def perturb(tree):
        return jax.tree.map(lambda a: prng.normal(0, 0.05, a.shape).astype(np.float32), tree)

    cn["controlnet_down_blocks"] = perturb(cn["controlnet_down_blocks"])
    cn["controlnet_mid_block"] = perturb(cn["controlnet_mid_block"])
    params["controlnet"] = cn
    plans = {
        "unet": PW.unet_plan(P.UNET_PRESETS["tiny"]),
        "controlnet": PW.controlnet_plan(P.UNET_PRESETS["tiny"]),
        "clip": PW.clip_plan(P.CLIP_PRESETS["tiny"]),
        "taesd": PW.taesd_plan(jb.taesd_cfg),
    }
    sds = {k: PW.state_dict_from_jax(params[k], plan) for k, plan in plans.items()}
    pb = P.ModelBundle.from_state_dicts("tiny", sds, dtype=torch.float32, device="cpu")
    jparams = jax.tree.map(jnp.asarray, params)
    ids = jnp.asarray(jb.tokenizer(["a portrait", "a landscape"]), jnp.int32)
    emb, _ = J.build_prompt_encoder(jb)(jparams, ids)
    return jb, jparams, pb, np.array(emb)


def _jax_noise(seeds, steps, latent_hw):
    """The JAX program's draws in the port's seam layout [S+1, B, h, w, 4]."""
    return np.stack([
        np.stack([np.asarray(jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(s), k),
                                               (*latent_hw, 4), jnp.float32)) for s in seeds])
        for k in range(steps + 1)
    ])


def _frames(hw=(32, 32), seed=5):
    return np.random.default_rng(seed).integers(0, 256, (B, *hw, 3), dtype=np.uint8)


def _mailbox(seed=11):
    """Two camera frames (48x64 and 64x40) in 64x64 mailboxes, with each
    element's center-crop box for a 32x32 target."""
    rng = np.random.default_rng(seed)
    mail = np.zeros((B, 64, 64, 3), np.uint8)
    boxes = []
    for b, (h, w) in enumerate(((48, 64), (64, 40))):
        mail[b, :h, :w] = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        left, top, right, bottom = center_crop_box(w, h, 32, 32)
        boxes.append([top, left, bottom - top, right - left])
    return mail, np.array(boxes, np.int32)


def _warm(seed=9):
    return np.random.default_rng(seed).standard_normal((B, 4, 4, 4)).astype(np.float32)


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


# (spec fields, frame, call kwargs) of the calls held against JAX; each
# case's calls run through one program, in order
CASES = {
    "parity": [({"steps": 2}, "rgb", {})],
    "cn_interval2": [({"steps": 4, "controlnet_interval": 2}, "rgb", {})],
    "temporal_produce_then_reuse": [({"steps": 3, "deepcache_temporal": True}, "rgb", {}),
                                    ({"steps": 3, "deepcache_temporal": True}, "rgb2", "caches")],
    "warm_start_src_box": [({"steps": 2, "in_height": 64, "in_width": 64}, "mailbox", "warm")],
}


def _inputs(kind, kw, caches=None):
    frame = {"rgb": _frames(), "rgb2": _frames(seed=6), "mailbox": _mailbox()[0]}[kind]
    if kw == "caches":
        return frame, {"deep_caches": caches}
    if kw == "warm":
        return frame, {"src_box": _mailbox()[1], "warm_latents": _warm(),
                       "warm_alpha": np.array([0.3, 0.6], np.float32)}
    return frame, dict(kw)


@pytest.mark.parametrize("case", list(CASES))
def test_staged_program_matches_jax(bundles, case):
    pb, emb = bundles[2], torch.from_numpy(bundles[3])
    calls = CASES[case]
    program = P.build_frame_program(pb, P.FrameSpec(batch=B, height=32, width=32, **calls[0][0]))
    caches = None
    for spec_kw, kind, kw in calls:
        frame, kw = _inputs(kind, kw, caches)
        spec_kw = {"batch": B, "height": 32, "width": 32, **spec_kw}
        ref = _run_jax(bundles, spec_kw, frame, **kw)
        noise = _jax_noise(ARGS[3].tolist(), spec_kw["steps"], (4, 4))
        port = program(frame, emb, *ARGS, noise=noise,
                       **{k: torch.from_numpy(np.array(v)) for k, v in kw.items()})
        _assert_close(port, ref)
        if len(ref) == 3:
            caches = ref[2]  # the JAX caches feed both sides' reuse call
    assert len(program.buckets) == len(calls)  # one signature per call kind


# call signatures for the buffer tests: (spec fields, kwargs of the first
# and the second call)
SIGNATURES = {
    "parity": ({"steps": 2}, {}),
    "temporal_reuse": ({"steps": 3, "deepcache_temporal": True}, "reuse"),
    "warm_start_src_box": ({"steps": 2, "in_height": 64, "in_width": 64}, "warm"),
    "safety_hook": ({"steps": 2}, "hook"),
}


def _signature_call(bundles, name, seed):
    """(bundle, spec, frame, kwargs) of one call of signature ``name``,
    whose frame and per-element values follow ``seed``."""
    pb = bundles[2]
    spec_kw, kind = SIGNATURES[name]
    spec = P.FrameSpec(batch=B, height=32, width=32, **spec_kw)
    rng = np.random.default_rng(seed)
    frame = rng.integers(0, 256, (B, 32, 32, 3), dtype=np.uint8)
    kw = {}
    if kind == "warm":
        frame, box = _mailbox(seed)
        kw = {"src_box": box, "warm_latents": rng.standard_normal((B, 4, 4, 4)).astype(np.float32),
              "warm_alpha": rng.uniform(0.1, 0.9, B).astype(np.float32)}
    if kind == "reuse":
        kw = {"deep_caches": rng.standard_normal((B, 3, 4, 4, 64)).astype(np.float32)}
    if kind == "hook":
        pb = dataclasses.replace(pb, safety_hook=PS.default_safety_hook(0.3))
    return pb, spec, frame, kw


@pytest.mark.parametrize("name", list(SIGNATURES))
def test_consecutive_calls_keep_their_own_results(bundles, name):
    """Two calls of one signature with other frames, seeds and values: each
    equals the eager ``frame_program`` of its own inputs bit for bit, the
    second writes the same static buffers as the first, and the first
    call's returned tensors are unchanged by the second."""
    emb = torch.from_numpy(bundles[3])
    pb, spec, _, _ = _signature_call(bundles, name, 0)
    program = P.build_frame_program(pb, spec)
    outs, wants, snapshots, pointers = [], [], [], []
    for seed in (31, 32):
        _, _, frame, kw = _signature_call(bundles, name, seed)
        args = (ARGS[0], ARGS[1], ARGS[2], np.array([seed, seed + 100], np.int32))
        outs.append(program(frame, emb, *args, **kw))
        snapshots.append([o.clone() for o in outs[-1]])
        wants.append(P.frame_program(pb, spec, frame, emb, *args, **kw))
        (bucket,) = program.buckets.values()
        pointers.append({k: v.data_ptr() for k, v in bucket.buffers.items() if v is not None})
    assert pointers[0] == pointers[1]  # the second call reused the first call's buffers
    for out, want, snap in zip(outs, wants, snapshots):
        assert len(out) == len(want)
        for got, ref, kept in zip(out, want, snap):
            assert torch.equal(got, ref)
            assert torch.equal(got, kept)
    assert not torch.equal(outs[0][1], outs[1][1])  # each call has its own answer
    assert all(o.data_ptr() != p for o in outs[0] for p in (x.data_ptr() for x in outs[1]))
    assert program.last_launches == dict.fromkeys(P.kernel_launches(), 0)  # no kernel on the CPU


# ---------------------------------------------------------------- capture safety


class HostAccess(AssertionError):
    """The body copied from the host or synced with it."""


class _NoHostDispatch(TorchDispatchMode):
    """Fails on an op that reads or writes a CPU tensor (a host-to-device or
    device-to-host copy, when the body's tensors live on a device) and on
    ``.item()`` or ``nonzero``, which wait for the device."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.overloadpacket in (torch.ops.aten._local_scalar_dense, torch.ops.aten.nonzero):
            raise HostAccess(f"{func} syncs with the host")
        tensors = [t for t in torch.utils._pytree.tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
        if any(t.device.type == "cpu" for t in tensors):
            raise HostAccess(f"{func} reads a CPU tensor")
        out = func(*args, **kwargs)
        if any(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               for t in torch.utils._pytree.tree_leaves(out)):
            raise HostAccess(f"{func} writes a CPU tensor")
        return out


class _NoHostData(TorchFunctionMode):
    """Fails where a tensor is made from host data (``torch.tensor``,
    ``new_tensor``, ``as_tensor`` of a list or scalar) or read back to it
    (``tolist``, ``item``, ``numpy``): on a device these copy, and the
    dispatcher never shows the copy to a dispatch mode."""

    FROM_HOST = {torch.tensor, torch.Tensor.new_tensor}
    TO_HOST = {torch.Tensor.tolist, torch.Tensor.item, torch.Tensor.numpy, torch.Tensor.cpu}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", func)
        if func in self.FROM_HOST or (func is torch.as_tensor
                                       and not isinstance(args[0], torch.Tensor)):
            raise HostAccess(f"{name} makes a tensor from host data")
        if func in self.TO_HOST:
            raise HostAccess(f"{name} reads a tensor back to the host")
        return func(*args, **(kwargs or {}))


class capture_guard:
    """Both guards, as one context manager."""

    def __enter__(self):
        self.modes = [_NoHostData(), _NoHostDispatch()]
        for mode in self.modes:
            mode.__enter__()

    def __exit__(self, *exc):
        for mode in reversed(self.modes):
            mode.__exit__(*exc)


def _meta_call(name):
    """(meta bundle, spec, frame, kwargs) of one call kind at its real shapes."""
    meta = P.ModelBundle.random("tiny", dtype=torch.float32, device="meta")
    spec = {"steps": 2}
    frame = _frames()
    kw = {}
    if name == "interval":
        spec = {"steps": 4, "controlnet_interval": 2, "deepcache_interval": 3,
                "interval_refresh_last": True}
    elif name == "temporal_produce":
        spec = {"steps": 3, "deepcache_temporal": True}
    elif name == "temporal_reuse":
        spec = {"steps": 3, "deepcache_temporal": True}
        kw = {"deep_caches": np.zeros((B, 3, 4, 4, 64), np.float32)}
    elif name == "warm_start_src_box_i420":
        spec = {"steps": 2, "in_height": 64, "in_width": 64, "in_format": "i420"}
        mail, box = _mailbox()
        frame = np.stack([rgb_to_i420_host(f) for f in mail])
        kw = {"src_box": box, "warm_latents": _warm(), "warm_alpha": [0.3, 0.6]}
    elif name == "resize":  # a 48x64 frame center-cropped and resized to 32x32
        frame = _frames(hw=(48, 64))
    elif name == "safety_hook":
        meta = dataclasses.replace(meta, safety_hook=PS.default_safety_hook(0.5))
    return meta, P.FrameSpec(batch=B, height=32, width=32, **spec), frame, kw


META_CALLS = ["parity", "interval", "temporal_produce", "temporal_reuse",
              "warm_start_src_box_i420", "resize", "safety_hook"]


@pytest.mark.parametrize("name", META_CALLS)
def test_body_makes_no_host_copy_or_sync(name):
    """The body of each call kind, on meta buffers, under the guards: what
    a CUDA graph capture needs.  As before a capture, one eager run first
    fills the caches built at first use (the resize matrices on the
    device)."""
    meta, spec, frame, kw = _meta_call(name)
    inputs = P._call_inputs(meta, spec, frame, np.zeros((B, 77, 32), np.float32), *ARGS[:3],
                            None, kw.get("warm_latents"), kw.get("warm_alpha"), None,
                            kw.get("src_box"), kw.get("deep_caches"))
    bufs = P._new_buffers(meta, spec, inputs)
    assert all(b is None or b.device.type == "meta" for b in bufs.values())
    with torch.inference_mode():
        warm = P._frame_body(meta, spec, **bufs)
        with capture_guard():
            out = P._frame_body(meta, spec, **bufs)
    assert [tuple(o.shape) for o in out] == [tuple(o.shape) for o in warm]
    assert out[0].shape == (B, 32, 32, 3) and out[0].dtype == torch.uint8


def _old_div_rn(x, d):  # the division before graphs: a host scalar copied per call
    return x / x.new_tensor(d)


# faults the guards must catch, each as the body would commit it on a device
FAULTS = {
    "new_tensor_divisor": lambda x: _old_div_rn(x, 255.0),
    "tensor_from_python_scalar": lambda x: x * torch.tensor(50.0, device=x.device),
    "numpy_constant": lambda x: x + torch.from_numpy(np.ones(4, np.float32)).to(x.device),
    "as_tensor_of_list": lambda x: x + torch.as_tensor([1.0, 2.0, 3.0, 4.0], device=x.device),
    "item": lambda x: x * x.sum().item(),
    "tolist": lambda x: x.tolist(),
    "nonzero": lambda x: torch.nonzero(x),
    "cpu": lambda x: x.cpu(),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_guard_catches_host_copies_and_syncs(fault):
    x = torch.zeros(4, device="meta")
    with pytest.raises((HostAccess, NotImplementedError, RuntimeError)) as err:
        with capture_guard():
            FAULTS[fault](x)
    assert isinstance(err.value, HostAccess), f"{fault} got past the guards: {err.value!r}"


def test_guard_passes_the_capture_safe_forms():
    """What replaced each fault: a divisor filled on the device, Python
    scalars in the arithmetic, and the where with a scalar branch."""
    x = torch.zeros(4, device="meta")
    with capture_guard():
        div_rn(x, 255.0)
        torch.floor(x * 50.0)
        torch.where(x > 0, -1.0, x)
