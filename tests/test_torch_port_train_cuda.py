"""Training over the port on the card: K1' and a train step.

Every test here is marked ``cuda`` and skips without a card; the file
imports neither JAX nor the JAX package::

    python -m pytest --noconftest -m cuda tests/test_torch_port_train_cuda.py

* K1' (``models/layers.py::FlashAttentionRecompute``) at the sd15 shape
  [8, 1024, 80] in bf16 and fp32: the output's ``grad_fn`` is the
  Function's, one K1 launch a forward and one launch of the backward kernel
  pair of its dtype; dq/dk/dv, fp32, within 1e-3 of each one's largest
  |value| from the gradient in fp64, bf16 within 2^-6 of it from the plain
  version's gradient on the inputs in fp32.
* The backward kernels at every instance width (and d = 20, 24, 72: a
  padded copy in bf16, columns below the instance's width) at 128 queries
  on 256 keys: the output of ``flash_attention_lse`` bit for bit that of
  ``flash_attention`` (K1 without the lse output), lse within 1e-5 of the
  plain version's, the gradients within 1e-4 (fp32, from fp64) or 2^-6
  (bf16, from ``flash_attention_bwd_reference``) of each one's largest.
* One UNet train step of the tiny family at 16^2 latents, fp32: three fp32
  K1 launches (its routed self-attentions), three of the fp32 backward
  kernels, and a nonzero, finite gradient
  for every self-attention projection, the routed ones included -- on the
  card the kernel's output carries no autograd history of its own.
* The same step sharded over a (2 x 2) mesh of ``cuda:0`` slots: 12 fp32
  K1 launches (2 data rows x 2 model ranks x 3) and 12 backward, the single-device step's
  loss within 1e-5 relative and its gradients within 1e-4 of each
  tensor's largest.
"""

import copy

import pytest
import torch

from videosd_tpu_torch.models import layers as PL
from videosd_tpu_torch.ops.cuda import flash_attention as FA
from videosd_tpu_torch.pipelines import lcm_img2img as P
from videosd_tpu_torch.train import optim as PO
from videosd_tpu_torch.train import step as PT


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


BF16_GRAD_REL = 2.0 ** -6  # two bf16 ulps of the largest |value|


def _zero():
    FA.launches = FA.launches_fp32 = FA.launches_bwd = FA.launches_bwd_fp32 = 0


def _grads_fp64(q, k, v, do, h):
    b, d = q.shape[0], q.shape[-1] // h

    def fold(x):
        return x.double().reshape(b, x.shape[1], h, d).transpose(1, 2)

    qd, kd, vd = (fold(x).requires_grad_(True) for x in (q, k, v))
    out = torch.softmax(qd @ kd.transpose(-1, -2) * d ** -0.5, -1) @ vd
    return [g.transpose(1, 2).reshape(x.shape)
            for g, x in zip(torch.autograd.grad(out, (qd, kd, vd), fold(do)), (q, k, v))]


def _within(got, want, rel):
    got, want = got.double(), want.double()
    return bool(torch.isfinite(got).all()) and (got - want).abs().max() <= rel * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_k1_prime_grads_equal_the_plain_versions_on_card(card, dtype):
    gen = torch.Generator(device="cuda").manual_seed(0)
    q0, k0, v0, do = (torch.randn(1, 1024, 640, generator=gen, device="cuda").to(dtype)
                      for _ in range(4))

    def grads(fn, cast=dtype):
        q, k, v = (x.to(cast).requires_grad_(True) for x in (q0, k0, v0))
        out = fn(q, k, v)
        return out, torch.autograd.grad(out, (q, k, v), do.to(cast))

    _zero()
    out, got = grads(lambda q, k, v: PL.attention(q, k, v, num_heads=8))
    assert type(out.grad_fn) is PL.FlashAttentionRecompute._backward_cls
    assert FA.launches + FA.launches_fp32 == 1
    fp32 = dtype == torch.float32
    assert (FA.launches_bwd_fp32, FA.launches_bwd) == ((1, 0) if fp32 else (0, 1))
    ref, _ = grads(lambda q, k, v: PL._attention_plain(q, k, v, 8))
    assert (out.float() - ref.float()).abs().max() <= 2e-2 * ref.float().abs().max()
    if fp32:
        want = _grads_fp64(q0, k0, v0, do, 8)
    else:
        want = grads(lambda q, k, v: PL._attention_plain(q, k, v, 8), torch.float32)[1]
    for g, w in zip(got, want):
        assert _within(g, w, 1e-3 if fp32 else BF16_GRAD_REL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("d", [8, 16, 20, 24, 40, 64, 72, 80, 160, 256])
def test_k1_backward_kernels_every_width_on_card(card, dtype, d):
    h, sq, sk = 2, 128, 256
    gen = torch.Generator(device="cuda").manual_seed(d)
    q, do = (torch.randn(2, sq, h * d, generator=gen, device="cuda").to(dtype) for _ in range(2))
    k, v = (torch.randn(2, sk, h * d, generator=gen, device="cuda").to(dtype) for _ in range(2))
    out, lse = FA.flash_attention_lse(q, k, v, num_heads=h)
    assert torch.equal(out, FA.flash_attention(q, k, v, num_heads=h))
    fold = [FA._split_heads(x, h) for x in (q, k, v, out, do)]
    _, lse_ref = FA.flash_attention_reference(*fold[:3], d ** -0.5, with_lse=True)
    assert (lse - lse_ref.reshape(2 * h, sq)).abs().max() <= 1e-5 * lse_ref.abs().max()
    _zero()
    got = FA.flash_attention_bwd(q, k, v, out, lse, do, h, d ** -0.5)
    torch.cuda.synchronize()
    fp32 = dtype == torch.float32
    assert (FA.launches_bwd_fp32, FA.launches_bwd) == ((1, 0) if fp32 else (0, 1))
    if fp32:
        want = _grads_fp64(q, k, v, do, h)
    else:
        want = [FA._merge_heads(g) for g in FA.flash_attention_bwd_reference(
            *fold[:4], lse.reshape(2, h, sq), fold[4], d ** -0.5)]
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert _within(g, w, 1e-4 if fp32 else BF16_GRAD_REL)


@pytest.mark.cuda
def test_tiny_unet_train_step_on_card(card):
    bundle = P.ModelBundle.random("tiny", dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    embeds, _ = P.build_prompt_encoder(bundle)(bundle.tokenizer(["a portrait"]))
    batch = {"latents": torch.randn(2, 16, 16, 4, generator=gen, device="cuda"),
             "context": embeds.repeat(2, 1, 1),
             "w_cond": torch.randn(2, bundle.unet_cfg.time_cond_proj_dim, generator=gen,
                                   device="cuda")}
    unet = bundle.models["unet"]
    state = PT.init_train_state(unet, PO.adamw(1e-4))
    _zero()
    loss = PT.make_train_step(bundle.sched_cfg)(state, batch, generator=gen)["loss"]
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert (FA.launches_fp32, FA.launches) == (3, 0)
    assert (FA.launches_bwd_fp32, FA.launches_bwd) == (3, 0)
    proj = {n: p.grad for n, p in unet.named_parameters()
            if n.endswith(("attn1.to_q.weight", "attn1.to_k.weight", "attn1.to_v.weight"))}
    assert len(proj) == 3 * 4  # down0, mid and up1 x 2; all but mid's routed
    for n, g in proj.items():
        assert g is not None and torch.isfinite(g).all() and g.abs().max() > 0, n


@pytest.mark.cuda
def test_tiny_sharded_train_step_on_card(card):
    from videosd_tpu_torch.parallel.mesh import make_mesh

    bundle = P.ModelBundle.random("tiny", dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    cfg = bundle.unet_cfg
    batch = {"latents": torch.randn(4, 16, 16, 4, generator=gen, device="cuda"),
             "context": torch.randn(4, 77, cfg.cross_attention_dim, generator=gen, device="cuda"),
             "w_cond": torch.randn(4, cfg.time_cond_proj_dim, generator=gen, device="cuda")}
    runs = []
    for mesh in (None, make_mesh(devices=[torch.device("cuda", 0)] * 4, model_parallel=2)):
        unet = copy.deepcopy(bundle.models["unet"])
        state = PT.init_train_state(unet, lambda m: torch.optim.SGD(m.parameters(), lr=0.0))
        _zero()
        loss = PT.make_train_step(bundle.sched_cfg, mesh=mesh)(
            state, batch, generator=torch.Generator(device="cuda").manual_seed(3))["loss"]
        torch.cuda.synchronize()
        runs.append((loss.item(), (FA.launches_fp32, FA.launches_bwd_fp32),
                     dict(unet.named_parameters())))
    (want_loss, _, want), (loss, launches, got) = runs
    assert launches == (2 * 2 * 3, 2 * 2 * 3)
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    for n, p in want.items():
        assert (got[n].grad - p.grad).abs().max() <= 1e-4 * p.grad.abs().max(), n
