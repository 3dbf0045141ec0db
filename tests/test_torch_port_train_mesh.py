"""The sharded UNet train step over the port (fp32, CPU).

``train/step.py::make_train_step(sched_cfg, mesh=mesh)`` on meshes of
repeated CPU slots (``[torch.device("cpu")] * 8``, as the JAX tests run on
eight virtual CPU devices), the tiny family (4 heads: m = 2 and 4 split
every attention and feed-forward) at 16^2 latents (self-attention routes
to K1'), batch 8:

* against JAX's sharded step (``videosd_tpu/train/step.py``, ``mesh =
  make_mesh(8, model_parallel=2)``, params placed by JAX's
  ``shard_params``) on the same weights and JAX's own draws (through the
  port's ``t=``/``noise=`` seam), on a (4 x 2) mesh: loss within 1e-5
  relative, every master gradient within 1e-4 of the largest absolute value
  of JAX's tensor (JAX's gradients read from a transform that keeps them, as
  ``test_torch_port_train.py`` does);
* against the port's single-device step: meshes (8 x 1), (4 x 2) and
  (2 x 4) under Adam, AdamW and Adafactor, two steps from one generator
  seed, every parameter tensor within 1e-2 * lr of the single-device
  step's in RMS, the first step's gradients within 1e-4 of the largest; an
  Adafactor stepping each tensor-parallel shard on its own misses that bar
  (its block RMS and parameter scale are statistics of the whole tensor);
* guards: tensor-parallel layers exist at m >= 2, every parameter with a
  gradient on one device has one on the mesh, a frozen source stays frozen.

The UNet's zero biases are drawn small first, so that no gradient sits at
zero and a bias added once per rank shows, and each attention's value heads
are scaled apart, so that a statistic of one shard is not the tensor's.  JAX's step is jitted once.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from videosd_tpu.io import weights as JW
from videosd_tpu.models.unet import UNET_PRESETS as J_UNET
from videosd_tpu.parallel import mesh as JM
from videosd_tpu.schedulers.lcm import LCMSchedulerConfig as JSched
from videosd_tpu.train import step as JT
from videosd_tpu_torch.io import weights as PW
from videosd_tpu_torch.models import layers as PL
from videosd_tpu_torch.models.unet import Attention
from videosd_tpu_torch.parallel.mesh import make_mesh
from videosd_tpu_torch.parallel.tensor import TensorParallel
from videosd_tpu_torch.pipelines import lcm_img2img as P
from videosd_tpu_torch.schedulers.lcm import LCMSchedulerConfig
from videosd_tpu_torch.train import optim
from videosd_tpu_torch.train import step as PT

# One torch thread per process, set at import: every xdist worker imports
# every test module, and torch threads on every core of every worker stall
# JAX's interpreted Pallas kernels in the worker that runs them.
torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8
B, LAT = 8, 16
LOSS_RTOL, GRAD_REL = 1e-5, 1e-4
LR, STEPS = 1e-3, 2
PARAM_BAR = 1e-2 * LR
MESHES = {"8x1": 1, "4x2": 2, "2x4": 4}
OPTIMIZERS = {"adam": optim.adam, "adamw": optim.adamw, "adafactor": optim.adafactor}
# routed self-attentions of one tiny UNet pass at 16^2 latents (down0's and
# up1's, 256 tokens)
ROUTED_PER_PASS = 3


def _capture():
    """An optax transform that applies no update and keeps the gradients as
    its state, so the JAX step's gradients can be read."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g),
    )


def _no_update(model):
    """A bound optimizer that leaves the weights as they are (lr 0), so the
    step's gradients stay readable on the parameters."""
    return torch.optim.SGD(model.parameters(), lr=0.0)


def _close_to_max(got, want, rel=GRAD_REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() <= rel * np.abs(want).max()


@pytest.fixture(scope="module")
def setup():
    cfg = P.UNET_PRESETS["tiny"]
    unet = P.ModelBundle.random("tiny", dtype=torch.float32, device="cpu").models["unet"]
    rng = np.random.default_rng(23)
    with torch.no_grad():
        for p in unet.parameters():
            if not p.abs().max() > 0:  # JAX's zero biases and zero-initialized convs
                p.copy_(torch.from_numpy(rng.normal(0, 0.05, p.shape).astype(np.float32)))
        # heads of unequal scale, as after training: head i's rows of every
        # to_v times 4^i / 8, so that a statistic over one shard of the
        # tensor is not the whole tensor's
        for mod in unet.modules():
            if isinstance(mod, Attention):
                scale = torch.tensor([4.0 ** i / 8 for i in range(mod.heads)])
                mod.to_v.weight.view(mod.heads, -1, mod.to_v.in_features).mul_(
                    scale.view(-1, 1, 1))
    batch = {
        "latents": rng.standard_normal((B, LAT, LAT, 4)).astype(np.float32),
        "context": rng.standard_normal((B, 77, cfg.cross_attention_dim)).astype(np.float32),
        "w_cond": rng.standard_normal((B, cfg.time_cond_proj_dim)).astype(np.float32),
    }
    jsched = JSched()
    key = jax.random.PRNGKey(7)
    kt, kn = jax.random.split(key)  # the JAX step's own draws (train/step.py's loss_fn)
    draws = (np.asarray(jax.random.randint(kt, (B,), 0, jsched.num_train_timesteps)),
             np.asarray(jax.random.normal(kn, (B, LAT, LAT, 4), jnp.float32)))
    jparams = JW.convert({k: v.numpy() for k, v in unet.state_dict().items()},
                         JW.unet_plan(J_UNET["tiny"]))
    jmesh = JM.make_mesh(8, model_parallel=2)
    step = JT.make_train_step(J_UNET["tiny"], jsched, _capture(), mesh=jmesh)
    state, metrics = step(JT.init_train_state(JM.shard_params(jparams, jmesh), _capture()),
                          {k: jnp.asarray(v) for k, v in batch.items()}, key)
    ref = (float(metrics["loss"]), jax.tree.map(np.asarray, state["opt_state"]))
    return {"unet": unet, "batch": {k: torch.from_numpy(v) for k, v in batch.items()},
            "draws": draws, "ref": ref, "plan": PW.unet_plan(cfg),
            "sched": LCMSchedulerConfig(), "singles": {}}


def _mesh(m):
    return make_mesh(devices=CPU8, model_parallel=m)


def _count_k1_prime(monkeypatch):
    seen = {"applied": 0}
    apply = PL.FlashAttentionRecompute.apply

    def counting_apply(*a):
        seen["applied"] += 1
        return apply(*a)

    monkeypatch.setattr(PL.FlashAttentionRecompute, "apply", counting_apply)
    return seen


def test_mesh_step_matches_jax_sharded_step(setup, monkeypatch):
    seen = _count_k1_prime(monkeypatch)
    unet = copy.deepcopy(setup["unet"])
    state = PT.init_train_state(unet, _no_update)
    t, noise = setup["draws"]
    mesh = _mesh(2)
    assert mesh.shape == {"data": 4, "model": 2}
    loss = PT.make_train_step(setup["sched"], mesh=mesh)(
        state, setup["batch"], t=torch.tensor(t), noise=torch.tensor(noise))["loss"]
    want_loss, jgrads = setup["ref"]
    assert abs(loss.item() - want_loss) <= LOSS_RTOL * abs(want_loss)
    want = PW.state_dict_from_jax(jgrads, setup["plan"])
    got = {n: p.grad for n, p in unet.named_parameters()}
    assert set(got) == set(want)
    bad = [n for n in want if got[n] is None or not _close_to_max(got[n].numpy(), want[n].numpy())]
    assert not bad, bad[:5]
    # every routed self-attention of every row ran K1' on each of its 2 ranks
    assert seen["applied"] == 4 * 2 * ROUTED_PER_PASS


def _rms(a, b) -> float:
    return (a.double() - b.double()).pow(2).mean().sqrt().item()


def _train(setup, opt, mesh):
    """``STEPS`` steps of ``opt`` from the perturbed start, draws from one
    generator seed: ``(parameters after, gradients of the first step)``."""
    unet = copy.deepcopy(setup["unet"])
    state = PT.init_train_state(unet, opt(LR))
    step = PT.make_train_step(setup["sched"], mesh=mesh)
    gen = torch.Generator().manual_seed(5)
    for i in range(STEPS):
        loss = step(state, setup["batch"], generator=gen)["loss"]
        assert torch.isfinite(loss)
        if i == 0:
            grads = {n: p.grad.clone() for n, p in unet.named_parameters()}
    return dict(unet.named_parameters()), grads


def _single(setup, name):
    if name not in setup["singles"]:
        setup["singles"][name] = _train(setup, OPTIMIZERS[name], None)
    return setup["singles"][name]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("opt_name", list(OPTIMIZERS))
def test_mesh_step_matches_single_device(setup, opt_name, mesh_name):
    """Each parameter tensor within 1e-2 * lr of the single-device step's in
    RMS over its elements, and the first step's gradients within 1e-4 of
    each tensor's largest.  (Elementwise, Adam's first update is ~lr *
    sign(g): on an element whose gradient cancels to ~1e-6 of its tensor's
    largest, the fp32 sums of a batch-8 and a batch-1 backward differ in
    sign often enough to move it by ~lr; measured 3.2e-2 * lr on one
    element of up_blocks.0.resnets.0.conv2.weight at (8 x 1).)"""
    want, want_g = _single(setup, opt_name)
    got, got_g = _train(setup, OPTIMIZERS[opt_name], _mesh(MESHES[mesh_name]))
    start = dict(setup["unet"].named_parameters())
    worst = max((_rms(got[n], want[n]), n) for n in want)
    assert worst[0] <= PARAM_BAR, worst
    bad = [n for n in want_g if not _close_to_max(got_g[n].numpy(), want_g[n].numpy())]
    assert not bad, bad[:5]
    # the steps moved the weights by far more than the bar
    assert max(_rms(want[n], start[n]) for n in want) > 100 * PARAM_BAR


def test_shard_local_adafactor_misses_the_bar(setup):
    """What the Adafactor case rules out: the (4 x 2) mesh's split tensors
    stepped by an Adafactor of their own shards, on the master's reduced
    gradients, land off the single-device step by more than the bar."""
    unet = copy.deepcopy(setup["unet"])
    state = PT.init_train_state(unet, _no_update)
    mesh = _mesh(2)
    step = PT.make_train_step(setup["sched"], mesh=mesh)
    step(state, setup["batch"], generator=torch.Generator().manual_seed(5))
    row = step.placements()[0]
    shards, offsets = [], []
    master = dict(unet.named_parameters())
    for key, p in row.models["unet"].named_parameters():
        _, sname, dim, index = row.sources[f"unet.{key}"]
        if index is not None:
            idx = torch.tensor([i for r in index for i in r])
            p.grad = master[sname].grad.index_select(dim, idx).clone()
            shards.append(p)
            offsets.append((sname, dim, idx))
    local = optim.Adafactor(shards, LR)
    local._layouts = optim.jax_layouts(row.models["unet"])
    with torch.no_grad():
        for p, (sname, dim, idx) in zip(shards, offsets):
            p.copy_(master[sname].index_select(dim, idx))
    local.step()
    whole = optim.adafactor(LR)(unet)
    whole.step()
    off = max(_rms(p, master[sname].index_select(dim, idx))
              for p, (sname, dim, idx) in zip(shards, offsets))
    assert off > 10 * PARAM_BAR, off


def test_mesh_guards(setup):
    unet = copy.deepcopy(setup["unet"])
    frozen = {n for n, _ in unet.named_parameters() if n.startswith(("conv_in.", "time_embedding."))}
    state = PT.init_train_state(unet, _no_update)
    for n, p in unet.named_parameters():
        if n in frozen:
            p.requires_grad_(False)
    mesh = _mesh(4)
    step = PT.make_train_step(setup["sched"], mesh=mesh)
    t, noise = setup["draws"]
    step(state, setup["batch"], t=torch.tensor(t), noise=torch.tensor(noise))
    rows = step.placements()
    assert len(rows) == 2 and all(r.models["unet"] is not unet for r in rows)
    for row in rows:
        tp = [m for m in row.models["unet"].modules() if isinstance(m, TensorParallel)]
        assert tp and all(len(m.shards) == 4 for m in tp)
        for key, p in row.models["unet"].named_parameters():
            _, sname, *_ = row.sources[f"unet.{key}"]
            assert p.requires_grad == (sname not in frozen), key
            assert p.grad is None  # the rows' gradients went into the master
    with_grad = {n for n, p in unet.named_parameters() if p.grad is not None}
    single = copy.deepcopy(setup["unet"])
    state1 = PT.init_train_state(single, _no_update)
    for n, p in single.named_parameters():
        if n in frozen:
            p.requires_grad_(False)
    PT.make_train_step(setup["sched"])(state1, setup["batch"], t=torch.tensor(t),
                                       noise=torch.tensor(noise))
    assert with_grad == {n for n, p in single.named_parameters() if p.grad is not None}
    assert with_grad and not with_grad & frozen
