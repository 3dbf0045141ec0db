"""Training over the port on the card: K1' and a train step.

Every test here is marked ``cuda`` and skips without a card; the file
imports neither JAX nor the JAX package::

    python -m pytest --noconftest -m cuda tests/test_torch_port_train_cuda.py

* K1' (``models/layers.py::FlashAttentionRecompute``) at the sd15 shape
  [8, 1024, 80] in bf16 and fp32: the output's ``grad_fn`` is the
  Function's, one K1 launch a forward, dq/dk/dv equal to autograd through
  the plain version (its backward is the plain version's own, recomputed
  on the same inputs).
* One UNet train step of the tiny family at 16^2 latents, fp32: three fp32
  K1 launches (its routed self-attentions) and a nonzero, finite gradient
  for every self-attention projection, the routed ones included -- on the
  card the kernel's output carries no autograd history of its own.
* The same step sharded over a (2 x 2) mesh of ``cuda:0`` slots: 12 fp32
  K1 launches (2 data rows x 2 model ranks x 3), the single-device step's
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_k1_prime_grads_equal_the_plain_versions_on_card(card, dtype):
    gen = torch.Generator(device="cuda").manual_seed(0)
    q0, k0, v0, do = (torch.randn(1, 1024, 640, generator=gen, device="cuda").to(dtype)
                      for _ in range(4))

    def grads(fn):
        q, k, v = (x.clone().requires_grad_(True) for x in (q0, k0, v0))
        out = fn(q, k, v)
        return out, torch.autograd.grad(out, (q, k, v), do)

    FA.launches = FA.launches_fp32 = 0
    out, got = grads(lambda q, k, v: PL.attention(q, k, v, num_heads=8))
    assert type(out.grad_fn) is PL.FlashAttentionRecompute._backward_cls
    assert FA.launches + FA.launches_fp32 == 1
    ref, want = grads(lambda q, k, v: PL._attention_plain(q, k, v, 8))
    assert (out.float() - ref.float()).abs().max() <= 2e-2 * ref.float().abs().max()
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert (g.float() - w.float()).abs().max() <= 1e-3 * w.float().abs().max()


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
    FA.launches = FA.launches_fp32 = 0
    loss = PT.make_train_step(bundle.sched_cfg)(state, batch, generator=gen)["loss"]
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert (FA.launches_fp32, FA.launches) == (3, 0)
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
        FA.launches = FA.launches_fp32 = 0
        loss = PT.make_train_step(bundle.sched_cfg, mesh=mesh)(
            state, batch, generator=torch.Generator(device="cuda").manual_seed(3))["loss"]
        torch.cuda.synchronize()
        runs.append((loss.item(), FA.launches_fp32, dict(unet.named_parameters())))
    (want_loss, _, want), (loss, launches, got) = runs
    assert launches == 2 * 2 * 3
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    for n, p in want.items():
        assert (got[n].grad - p.grad).abs().max() <= 1e-4 * p.grad.abs().max(), n
