"""The backward of K1' on the CPU against the JAX package.

``ops/cuda/flash_attention.py::flash_attention_bwd_reference`` is the
formula of the backward kernels (``csrc/flash_attention_bwd.cu``,
``csrc/flash_attention_bwd_fp32.cu``): P recomputed from the forward's row
log-sum-exp, D = rowsum(dO o), P and dS rounded to the input dtype before
their products.  On the CPU, ``flash_attention_lse`` and
``flash_attention_bwd`` take the plain versions, so ``models/layers.py::
FlashAttentionRecompute`` runs that same formula.  Here, on inputs drawn from
a numpy seed at every instance width of the kernels (d = 8 .. 256) and at
Sk != Sq:

* lse against ``jax.nn.logsumexp`` of JAX's scaled fp32 logits, and the
  forward against ``_attention_xla`` (fp32: 1e-5 of the largest |value|);
* the reference's dq/dk/dv and the Function's against ``jax.vjp`` of
  ``videosd_tpu.models.layers._attention_xla`` (what the JAX ``custom_vjp``
  differentiates): fp32 within 1e-4 of each tensor's largest |value|
  (measured ~1e-6); bf16 within 2^-6 of it, two bf16 ulps at the top binade
  (measured up to 6.4e-3: P and dS round to bf16 at other points than JAX's
  autodiff does);
* above d = 256 (no backward kernel) the Function keeps the recomputed plain
  backward, with the same bars;
* the wrapper's refusals.

No Pallas kernel runs here; JAX's vjp is jitted once per shape, on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videosd_tpu.models import layers as JL
from videosd_tpu_torch.models import layers as PL
from videosd_tpu_torch.ops.cuda import flash_attention as FA

torch.set_num_threads(1)

HEADS = 2
REL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}
JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# (Sq, Sk, d): every instance width at 128 queries on 256 keys, then Sk = Sq
# and Sk < Sq
SHAPES = [(128, 256, d) for d in FA.INSTANCE_WIDTHS] + [(256, 256, 40), (256, 128, 80)]


def _inputs(sq, sk, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, s, HEADS * d)).astype(np.float32) for s in (sq, sk, sk, sq)]


def _close(got, want, rel):
    got, want = (np.asarray(x, np.float64) for x in (got, want))
    return np.abs(got - want).max() <= rel * np.abs(want).max()


@jax.jit
def _out_and_vjp(q, k, v, g):
    out, vjp = jax.vjp(lambda a, b, c: JL._attention_xla(a, b, c, HEADS), q, k, v)
    return out, vjp(g)


def _jax_vjp(q, k, v, g, dtype):
    jq, jk, jv, jg = (jnp.asarray(x, dtype=JAX_DTYPE[dtype]) for x in (q, k, v, g))
    return (*_out_and_vjp(jq, jk, jv, jg), (jq, jk))


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_backward_formula_and_function_equal_jax_vjp(shape, dtype):
    sq, sk, d = shape
    q, k, v, g = _inputs(sq, sk, d, seed=sum(shape))
    jout, jgrads, (jq, jk) = _jax_vjp(q, k, v, g, dtype)
    tq, tk, tv, tg = (torch.from_numpy(x).to(dtype) for x in (q, k, v, g))

    out, lse = FA.flash_attention_lse(tq, tk, tv, num_heads=HEADS)
    assert torch.equal(out, FA.flash_attention(tq, tk, tv, num_heads=HEADS))
    assert lse.shape == (HEADS, sq) and lse.dtype == torch.float32
    jh = [x.astype(jnp.float32).reshape(1, -1, HEADS, d).transpose(0, 2, 1, 3) for x in (jq, jk)]
    logits = jnp.einsum("bhqd,bhkd->bhqk", *jh) * d ** -0.5
    assert _close(_np(lse), jax.nn.logsumexp(logits, axis=-1).reshape(HEADS, sq), 1e-6)
    if dtype == torch.float32:
        assert _close(_np(out), jout, 1e-5)

    grads = FA.flash_attention_bwd(tq, tk, tv, out, lse, tg, HEADS, d ** -0.5)
    for got, want in zip(grads, jgrads):
        assert got.dtype == dtype and got.shape == want.shape
        assert _close(_np(got), np.asarray(want, np.float32), REL[dtype])

    # the Function, at any shape (attention() routes only Sk >= 256)
    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    fout = PL.FlashAttentionRecompute.apply(*leaves, HEADS)
    assert torch.equal(fout, out)
    fout.backward(tg)
    for leaf, want in zip(leaves, grads):
        assert torch.equal(leaf.grad, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_function_keeps_the_plain_backward_above_256(dtype):
    """d = 320: K1's wide kernels write no lse and no backward kernel takes
    it, so the Function saves q, k, v and differentiates the plain math."""
    sq, sk, d = 128, 256, 320
    q, k, v, g = _inputs(sq, sk, d, seed=7)
    _, jgrads, _ = _jax_vjp(q, k, v, g, dtype)
    leaves = [torch.from_numpy(x).to(dtype).requires_grad_(True) for x in (q, k, v)]
    out = PL.FlashAttentionRecompute.apply(*leaves, HEADS)
    assert len(out.grad_fn.saved_tensors) == 3
    out.backward(torch.from_numpy(g).to(dtype))
    for leaf, want in zip(leaves, jgrads):
        assert _close(_np(leaf.grad), np.asarray(want, np.float32), REL[dtype])
    with pytest.raises(ValueError, match="write no lse"):
        FA.flash_attention_lse(*leaves, num_heads=HEADS)


def test_function_saves_output_and_lse_up_to_256():
    q, k, v, _ = _inputs(128, 256, 40, seed=3)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = PL.FlashAttentionRecompute.apply(*leaves, HEADS)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 5 and saved[4].shape == (HEADS, 128)
    assert torch.equal(saved[3], out.detach())


def _refusal_inputs(dtype=torch.float32, sq=128, sk=128, d=40, device="cpu"):
    q, k, v, g = (torch.from_numpy(x).to(dtype).to(device) for x in _inputs(sq, sk, d, seed=1))
    lse = torch.zeros(HEADS, sq, device=device)
    return q, k, v, q.clone(), lse, g


def test_backward_wrapper_refusals():
    q, k, v, o, lse, g = _refusal_inputs()
    with pytest.raises(ValueError, match="shaped as q"):
        FA.flash_attention_bwd(q, k, v, o[:, :64], lse, g, HEADS, 0.1)
    with pytest.raises(ValueError, match="shaped as q"):
        FA.flash_attention_bwd(q, k, v, o, lse, g[:, :, :40], HEADS, 0.1)
    with pytest.raises(ValueError, match="lse must be fp32"):
        FA.flash_attention_bwd(q, k, v, o, lse[:, :64], g, HEADS, 0.1)
    with pytest.raises(ValueError, match="lse must be fp32"):
        FA.flash_attention_bwd(q, k, v, o, lse.double(), g, HEADS, 0.1)
    with pytest.raises(ValueError, match="expected"):
        FA.flash_attention_bwd(q, k, v, o, lse, g, 3, 0.1)
    # what the kernels refuse, checked before any launch: float16, sequence
    # lengths off the 64 grid, tensors off a CUDA device
    h = _refusal_inputs(torch.float16)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        FA._launch_bwd(*h, HEADS, 0.1)
    r = _refusal_inputs(sq=96)
    with pytest.raises(ValueError, match="multiples of 64"):
        FA._launch_bwd(*r, HEADS, 0.1)
    m = _refusal_inputs(device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        FA.flash_attention_bwd(*m, HEADS, 0.1)
    with pytest.raises(ValueError, match="CUDA device"):
        FA.flash_attention_lse(*m[:3], num_heads=HEADS)
