"""Training over the port against the JAX package (fp32, CPU).

* K1' (``models/layers.py::FlashAttentionRecompute``): a routed attention
  under autograd has the Function as its ``grad_fn`` and JAX's gradients
  (``jax.vjp`` of ``_attention_xla``, which the JAX ``custom_vjp``'s
  backward differentiates), also when the forward comes back detached, as
  the card's ``ctypes`` kernel returns it: the case that would have caught
  routed attentions cutting the autograd graph on the card.
* ``train/step.py``: the UNet step, the ControlNet step (``t_max``) and
  the paired ControlNet eval on the tiny family at 16^2 latents (128^2
  frames), a size where self-attention routes to K1', against the JAX
  steps on the same weights, timesteps and noise (JAX's own draws, passed
  through the port's ``t=``/``noise=`` seam).  The JAX step's gradients are
  read from a transform that keeps them as its state.  Loss within 1e-5
  relative, every gradient tensor within 1e-4 of the largest absolute value
  of JAX's tensor (``tests/test_torch_parity_composed.py``'s bar).
* Kernels without a backward (K2, K3) raise under grad and run under
  ``no_grad``.

Each JAX function is jitted once in this file.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from videosd_tpu.io import weights as JW
from videosd_tpu.models import layers as JL
from videosd_tpu.models.unet import UNET_PRESETS as J_UNET
from videosd_tpu.schedulers.lcm import LCMSchedulerConfig as JSched
from videosd_tpu.train import step as JT
from videosd_tpu_torch.io import weights as PW
from videosd_tpu_torch.models import layers as PL
from videosd_tpu_torch.ops.cuda import preprocess_kernel, taesd_conv
from videosd_tpu_torch.parallel.mesh import make_mesh
from videosd_tpu_torch.pipelines import lcm_img2img as P
from videosd_tpu_torch.schedulers.lcm import LCMSchedulerConfig
from videosd_tpu_torch.train import step as PT

# One torch thread per process, set at import: every xdist worker imports
# every test module, and torch threads on every core of every worker stall
# JAX's interpreted Pallas kernels in the worker that runs them.
torch.set_num_threads(1)

LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
B, LAT = 2, 16  # 16^2 latents: 256 tokens in the first stage, a routed shape
T_MAX = 600


def _close_to_max(got, want, rel=GRAD_REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() <= rel * np.abs(want).max()


# ------------------------------------------------------------------ K1'


def _qkv(seed=0, shape=(1, 256, 80)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def _detached(monkeypatch):
    """``flash_attention`` returning a result without autograd history, as
    the card's kernel (filled through ctypes) does."""
    orig = PL.flash_attention

    def kernel_like(q, k, v, *, num_heads):
        return orig(q, k, v, num_heads=num_heads).detach()

    monkeypatch.setattr(PL, "flash_attention", kernel_like)
    return kernel_like


@pytest.mark.parametrize("detached", [False, True], ids=["plain_forward", "detached_forward"])
def test_routed_attention_grads_equal_jax_vjp(monkeypatch, detached):
    q, k, v, g = _qkv()
    assert PL.routes_to_flash(256, 256, False)
    if detached:
        kernel_like = _detached(monkeypatch)
        # what the Function repairs: the kernel's own output has no history
        t = torch.from_numpy(q).requires_grad_(True)
        assert kernel_like(t, t, t, num_heads=2).grad_fn is None
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = PL.attention(tq, tk, tv, num_heads=2)
    assert type(out.grad_fn) is PL.FlashAttentionRecompute._backward_cls
    out.backward(torch.from_numpy(g))

    jout, vjp = jax.vjp(lambda a, b, c: JL._attention_xla(a, b, c, 2), q, k, v)
    assert _close_to_max(out.detach().numpy(), jout, 1e-5)
    for got, want in zip((tq.grad, tk.grad, tv.grad), vjp(jnp.asarray(g))):
        assert _close_to_max(got.numpy(), want)


def test_attention_takes_the_function_only_where_a_gradient_is_wanted():
    q, k, v, _ = _qkv(1)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    assert PL.attention(tq, tk, tv, num_heads=2).grad_fn is None  # nothing requires grad
    w = torch.from_numpy(q).requires_grad_(True)
    with torch.no_grad():
        assert PL.attention(w, tk, tv, num_heads=2).grad_fn is None
    with torch.inference_mode():
        assert PL.attention(w, tk, tv, num_heads=2).grad_fn is None
    # one input that requires grad is enough; the others get no gradient
    out = PL.attention(tq, tk, w, num_heads=2)
    assert type(out.grad_fn) is PL.FlashAttentionRecompute._backward_cls
    out.sum().backward()
    assert w.grad is not None and torch.isfinite(w.grad).all()
    # an unrouted shape (77 keys) keeps the plain math's own autograd
    kk = torch.from_numpy(np.ones((1, 77, 80), np.float32))
    out = PL.attention(w, kk, kk, num_heads=2)
    assert not isinstance(out.grad_fn, PL.FlashAttentionRecompute._backward_cls)


# ------------------------------------------------------------------ the steps


def _capture():
    """An optax transform that applies no update and keeps the gradients as
    its state, so the JAX step's gradients can be read."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g),
    )


@pytest.fixture(scope="module")
def setup():
    # the weights are the port's tiny init (fast on the CPU), crossed into
    # JAX's tree with JAX's own plan; the ControlNet's zero-initialized convs
    # made nonzero, so gradients reach its whole trunk (its routed attention
    # included)
    cfg = P.UNET_PRESETS["tiny"]
    pb = P.ModelBundle.random("tiny", dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(3)
    with torch.no_grad():
        for name, p in pb.models["controlnet"].named_parameters():
            if name.startswith(P.ControlNetModel.ZERO_INIT) and p.ndim == 4:
                p.copy_(torch.from_numpy(0.05 * rng.standard_normal(p.shape)))
    sds = {name: {k: v.clone() for k, v in pb.models[name].state_dict().items()}
           for name in ("unet", "controlnet")}
    plans = {"unet": PW.unet_plan(cfg), "controlnet": PW.controlnet_plan(cfg)}
    jplans = {"unet": JW.unet_plan(J_UNET["tiny"]), "controlnet": JW.controlnet_plan(J_UNET["tiny"])}
    jparams = {name: JW.convert({k: v.numpy() for k, v in sds[name].items()}, jplans[name])
               for name in sds}
    jsched = JSched()
    batch = {
        "latents": rng.standard_normal((B, LAT, LAT, 4)).astype(np.float32),
        "context": rng.standard_normal((B, 77, cfg.cross_attention_dim)).astype(np.float32),
        "w_cond": rng.standard_normal((B, cfg.time_cond_proj_dim)).astype(np.float32),
        "control": rng.uniform(0, 1, (B, 8 * LAT, 8 * LAT, 3)).astype(np.float32),
    }
    key = jax.random.PRNGKey(11)
    # the JAX steps' own draws (train/step.py's loss_fn)
    kt, kn = jax.random.split(key)
    draws = {}
    for name, t_hi in (("unet", jsched.num_train_timesteps), ("controlnet", T_MAX)):
        draws[name] = (np.asarray(jax.random.randint(kt, (B,), 0, t_hi)),
                       np.asarray(jax.random.normal(kn, (B, LAT, LAT, 4), jnp.float32)))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    step = JT.make_train_step(J_UNET["tiny"], jsched, _capture())
    state, metrics = step(JT.init_train_state(jparams["unet"], _capture()),
                          {k: jbatch[k] for k in ("latents", "context", "w_cond")}, key)
    ref = {"unet": (float(metrics["loss"]), jax.tree.map(np.asarray, state["opt_state"]))}
    cn_step = JT.make_controlnet_train_step(J_UNET["tiny"], jsched, _capture(), t_max=T_MAX)
    # the step donates its state: a copy of the ControlNet's weights goes in
    state, metrics = cn_step(JT.init_train_state(jax.tree.map(jnp.array, jparams["controlnet"]),
                                                 _capture()), jparams["unet"], jbatch, key)
    ref["controlnet"] = (float(metrics["loss"]), jax.tree.map(np.asarray, state["opt_state"]))
    ev_t = np.array([90, 599], np.int32)
    ev_key = jax.random.PRNGKey(31337)
    ref["eval"] = [float(x) for x in JT.make_controlnet_eval(J_UNET["tiny"], jsched)(
        jparams["controlnet"], jparams["unet"], jbatch, jnp.asarray(ev_t), ev_key)]
    ref["eval_inputs"] = (ev_t, np.asarray(jax.random.normal(ev_key, (B, LAT, LAT, 4))))
    return {"sds": sds, "plans": plans, "batch": batch, "draws": draws, "ref": ref,
            "sched": LCMSchedulerConfig()}


def _port(setup):
    bundle = P.ModelBundle.from_state_dicts("tiny", setup["sds"], dtype=torch.float32,
                                            device="cpu")
    return bundle, {k: torch.from_numpy(v) for k, v in setup["batch"].items()}


def _no_update(model):
    """A bound optimizer that leaves the weights as they are (lr 0), so the
    step's gradients stay readable on the parameters."""
    return torch.optim.SGD(model.parameters(), lr=0.0)


def _count_k1_prime(monkeypatch):
    """Counts K1' applications, and routes_to_flash over every attention call."""
    seen = {"applied": 0, "routed": 0}
    apply, attention = PL.FlashAttentionRecompute.apply, PL.attention

    def counting_apply(*a):
        seen["applied"] += 1
        return apply(*a)

    def recording_attention(q, k, v, *, num_heads, mask=None):
        seen["routed"] += PL.routes_to_flash(q.shape[1], k.shape[1], mask is not None)
        return attention(q, k, v, num_heads=num_heads, mask=mask)

    monkeypatch.setattr(PL.FlashAttentionRecompute, "apply", counting_apply)
    from videosd_tpu_torch.models import unet as PU

    monkeypatch.setattr(PU, "attention", recording_attention)
    return seen


def _grads_match(model, plan, jgrads):
    want = PW.state_dict_from_jax(jgrads, plan)
    got = {name: p.grad for name, p in model.named_parameters()}
    assert set(got) == set(want)
    bad = [n for n in want if got[n] is None or not _close_to_max(got[n].numpy(), want[n].numpy())]
    assert not bad, bad[:5]


@pytest.mark.parametrize("detached", [False, True], ids=["plain_forward", "detached_forward"])
def test_unet_train_step_matches_jax(setup, monkeypatch, detached):
    if detached:
        _detached(monkeypatch)
    seen = _count_k1_prime(monkeypatch)
    bundle, batch = _port(setup)
    unet = bundle.models["unet"]
    before = {n: p.detach().clone() for n, p in unet.named_parameters()}
    state = PT.init_train_state(unet, _no_update)
    t, noise = setup["draws"]["unet"]
    step = PT.make_train_step(setup["sched"])
    loss = step(state, {k: batch[k] for k in ("latents", "context", "w_cond")},
                t=torch.tensor(t), noise=torch.tensor(noise))["loss"]
    want_loss, jgrads = setup["ref"]["unet"]
    assert abs(loss.item() - want_loss) <= LOSS_RTOL * abs(want_loss)
    _grads_match(unet, setup["plans"]["unet"], jgrads)
    # down0's and up1's self-attentions at 256 tokens: every routed one went
    # through K1', and the UNet routes some
    assert seen["applied"] == seen["routed"] == 3
    assert all(torch.equal(p, before[n]) for n, p in unet.named_parameters())


@pytest.mark.parametrize("detached", [False, True], ids=["plain_forward", "detached_forward"])
def test_controlnet_train_step_matches_jax(setup, monkeypatch, detached):
    if detached:
        _detached(monkeypatch)
    seen = _count_k1_prime(monkeypatch)
    bundle, batch = _port(setup)
    cn, unet = bundle.models["controlnet"], bundle.models["unet"]
    unet.requires_grad_(True)  # the step freezes it
    state = PT.init_train_state(cn, _no_update)
    t, noise = setup["draws"]["controlnet"]
    assert t.max() < T_MAX
    step = PT.make_controlnet_train_step(setup["sched"], t_max=T_MAX)
    loss = step(state, unet, batch, t=torch.tensor(t), noise=torch.tensor(noise))["loss"]
    want_loss, jgrads = setup["ref"]["controlnet"]
    assert abs(loss.item() - want_loss) <= LOSS_RTOL * abs(want_loss)
    _grads_match(cn, setup["plans"]["controlnet"], jgrads)
    assert all(not p.requires_grad and p.grad is None for p in unet.parameters())
    # the ControlNet's routed attention and the UNet's up1 (its input carries
    # the residuals' gradient); the UNet's down0 runs the kernel without it
    assert seen["routed"] == 4 and seen["applied"] == 3


def test_controlnet_eval_matches_jax(setup):
    bundle, batch = _port(setup)
    t, noise = setup["ref"]["eval_inputs"]
    base, with_cn = PT.make_controlnet_eval(setup["sched"])(
        bundle.models["controlnet"], bundle.models["unet"], batch, torch.tensor(t),
        noise=torch.tensor(noise))
    for got, want in zip((base.item(), with_cn.item()), setup["ref"]["eval"]):
        assert abs(got - want) <= LOSS_RTOL * abs(want)
    assert base.item() != with_cn.item()  # the perturbed ControlNet is not a no-op


def test_steps_need_draws_and_one_device(setup):
    bundle, batch = _port(setup)
    state = PT.init_train_state(bundle.models["unet"], _no_update)
    step = PT.make_train_step(setup["sched"])
    with pytest.raises(ValueError, match="generator"):
        step(state, batch)
    with pytest.raises(ValueError, match="together"):
        step(state, batch, t=torch.zeros(B, dtype=torch.long))
    # the sharded step (tests/test_torch_port_train_mesh.py) on a (2 x 1) mesh
    # of CPU slots: the single-device step's loss and gradients on JAX's draws
    t, noise = setup["draws"]["unet"]
    draws = {"t": torch.tensor(t), "noise": torch.tensor(noise)}
    one = {k: batch[k] for k in ("latents", "context", "w_cond")}
    single = step(state, one, **draws)["loss"]
    want = {n: p.grad.clone() for n, p in bundle.models["unet"].named_parameters()}
    mesh_unet = _port(setup)[0].models["unet"]
    mesh = make_mesh(devices=[torch.device("cpu")] * 2)
    sharded = PT.make_train_step(setup["sched"], mesh=mesh)(
        PT.init_train_state(mesh_unet, _no_update), one, **draws)["loss"]
    assert abs(sharded.item() - single.item()) <= LOSS_RTOL * abs(single.item())
    assert all(_close_to_max(p.grad.numpy(), want[n].numpy())
               for n, p in mesh_unet.named_parameters())
    # a generator's draws: a finite loss, and the same draws give the same loss
    losses = [step(state, batch, generator=torch.Generator().manual_seed(5))["loss"]
              for _ in range(2)]
    assert torch.isfinite(losses[0]) and torch.equal(losses[0], losses[1])


# ------------------------------------------------------------------ kernels without a backward


def test_k2_k3_refuse_grad_and_run_without_it():
    rng = np.random.default_rng(0)
    weight = torch.from_numpy(rng.standard_normal((64, 64, 3, 3)).astype(np.float32) * 0.05)
    bias = torch.zeros(64)
    xp = torch.from_numpy(rng.standard_normal((1, 8, 4, 128)).astype(np.float32))
    gray = torch.from_numpy(rng.uniform(0, 1, (16, 16)).astype(np.float32))
    for args in ((weight.clone().requires_grad_(True), bias, xp),
                 (weight, bias.clone().requires_grad_(True), xp),
                 (weight, bias, xp.clone().requires_grad_(True))):
        with pytest.raises(RuntimeError, match="no backward"):
            taesd_conv.packed_conv3x3(*args, relu=True)
        with torch.no_grad():
            out = taesd_conv.packed_conv3x3(*args, relu=True)
        assert out.shape == xp.shape and out.grad_fn is None
    with pytest.raises(RuntimeError, match="no backward"):
        taesd_conv.packed_conv3x3(weight, bias, xp, relu=False,
                                  skip=xp.clone().requires_grad_(True))
    with pytest.raises(RuntimeError, match="no backward"):
        preprocess_kernel.sobel_magnitude(gray.clone().requires_grad_(True))
    with torch.no_grad():
        mag = preprocess_kernel.sobel_magnitude(gray.clone().requires_grad_(True))
    torch.testing.assert_close(mag, preprocess_kernel.sobel_magnitude(gray), rtol=0, atol=0)
