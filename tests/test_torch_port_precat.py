"""The port's pre-concatenated attention weights
(``models/unet.py::precat_attention_weights``, the ``wqkv``/``wkv`` branch
of ``Attention.forward``, their TP rule and split) against the JAX
package's (fp32, CPU).

Weights are a random tiny port bundle's, converted by JAX's own plans (the
ControlNet's zero-initialized output convs filled with random values), as
in ``test_torch_port_quant.py``; inputs are seeded numpy arrays.  Bars: the
forward within 1e-4 relative of JAX's precat forward (the port's bar
against JAX), and bit for bit the port without precat (the same GEMM over
the same values); one int8 attention within 1e-3 relative L2 of JAX's w8a8
one (``test_torch_port_quant.py``'s bar); gradients within 1e-4 relative
of ``jax.grad``'s; the TP-2 placement within 1e-6 relative of the whole
model (partial sums in fp32, as ``test_torch_port_parallel.py``).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import DictKey

from videosd_tpu.io import weights as JW
from videosd_tpu.models import layers as JL
from videosd_tpu.models import unet as JU
from videosd_tpu.models.controlnet import controlnet_apply as j_cn
from videosd_tpu.models.unet import UNET_PRESETS as J_UNET
from videosd_tpu.models.unet import unet_apply as j_unet
from videosd_tpu.ops import quant as JQ
from videosd_tpu.parallel import mesh as JM
from videosd_tpu_torch.io import weights as PW
from videosd_tpu_torch.io.checkpoint import save_bundle
from videosd_tpu_torch.io.safetensors import read_safetensors
from videosd_tpu_torch.models import (
    UNET_PRESETS,
    ControlNetModel,
    UNet2DConditionModel,
    controlnet_apply,
    precat_attention_weights,
    unet_apply,
)
from videosd_tpu_torch.models.layers import LinearW8A8
from videosd_tpu_torch.models.unet import Attention, BasicTransformerBlock
from videosd_tpu_torch.ops import quant as PQ
from videosd_tpu_torch.parallel.mesh import make_mesh, param_spec, shard_params
from videosd_tpu_torch.parallel.tensor import TensorParallel
from videosd_tpu_torch.pipelines.lcm_img2img import ModelBundle

# One torch thread per process, set at import: every xdist worker imports
# every test module, and torch threads on every core of every worker stall
# JAX's interpreted Pallas kernels in the worker that runs them.
torch.set_num_threads(1)

CFG = UNET_PRESETS["tiny"]
JCFG = J_UNET["tiny"]
REL = 1e-4
INT8_REL = 1e-3
CPU8 = [torch.device("cpu")] * 8
PLANS = {"unet": (PW.unet_plan, JW.unet_plan), "controlnet": (PW.controlnet_plan,
                                                              JW.controlnet_plan)}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def bundle():
    """A random tiny port bundle (fp32, CPU) with the ControlNet's output
    convs filled, and its UNet and ControlNet as JAX trees (numpy leaves)
    converted by JAX's own plans."""
    b = ModelBundle.random("tiny", dtype=torch.float32, device="cpu")
    r = np.random.default_rng(11)
    cn = b.models["controlnet"]
    with torch.no_grad():
        for conv in list(cn.controlnet_down_blocks) + [cn.controlnet_mid_block]:
            conv.weight.copy_(torch.from_numpy(
                (r.standard_normal(tuple(conv.weight.shape)) * 0.3).astype(np.float32)))
            conv.bias.copy_(torch.from_numpy(
                (r.standard_normal(tuple(conv.bias.shape)) * 0.1).astype(np.float32)))
    trees = {name: jax.tree.map(np.asarray, JW.convert(
        {k: v.numpy() for k, v in b.models[name].state_dict().items()}, PLANS[name][1](JCFG)))
        for name in PLANS}
    return b, trees


def _port(name, tree):
    mod = (UNet2DConditionModel if name == "unet" else ControlNetModel)(CFG).eval()
    mod.load_state_dict(PW.state_dict_from_jax(tree, PLANS[name][0](CFG)), strict=True)
    return mod


def _inputs(seed=1, batch=2, side=8):
    r = np.random.default_rng(seed)
    return dict(
        x=r.standard_normal((batch, side, side, 4)).astype(np.float32),
        t=np.array([999, 259][:batch], np.int32),
        ctx=r.standard_normal((batch, 77, CFG.cross_attention_dim)).astype(np.float32),
        w=r.standard_normal((batch, CFG.time_cond_proj_dim)).astype(np.float32),
        cond=r.uniform(0, 1, (batch, side * 8, side * 8, 3)).astype(np.float32),
    )


def _run_jax(name, tree, a):
    if name == "unet":
        fn = jax.jit(lambda p, x, t, c, w: j_unet(p, JCFG, x, t, c, timestep_cond=w))
        return [np.asarray(fn(tree, a["x"], a["t"], a["ctx"], a["w"]))]
    fn = jax.jit(lambda p, x, t, c, cond, w: j_cn(p, JCFG, x, t, c, cond,
                                                   conditioning_scale=1.0, timestep_cond=w))
    down, mid = fn(tree, a["x"], a["t"], a["ctx"], a["cond"], a["w"])
    return [np.asarray(v) for v in list(down) + [mid]]


def _run_port(name, mod, a):
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    with torch.no_grad():
        if name == "unet":
            return [unet_apply(mod, t["x"], t["t"], t["ctx"], timestep_cond=t["w"]).numpy()]
        down, mid = controlnet_apply(mod, t["x"], t["t"], t["ctx"], t["cond"],
                                     conditioning_scale=1.0, timestep_cond=t["w"])
        return [v.numpy() for v in list(down) + [mid]]


def _fused(mod) -> dict:
    """``{state-dict key: tensor}`` of ``mod``'s fused weights."""
    return {k: v for k, v in mod.state_dict().items() if k.endswith((".wqkv", ".wkv"))}


# ------------------------------------------------------------------ one block


def _block_pair(seed=3, dim=32, ctx_dim=24, heads=4):
    """A port ``BasicTransformerBlock``'s attentions with seeded weights, and
    the same two attentions as JAX trees."""
    r = np.random.default_rng(seed)
    cfg = dataclasses.replace(CFG, cross_attention_dim=ctx_dim)
    block = BasicTransformerBlock(cfg, dim, heads).eval()
    tree = {}
    with torch.no_grad():
        for name in ("attn1", "attn2"):
            attn = getattr(block, name)
            tree[name] = {}
            for proj in ("to_q", "to_k", "to_v", "to_out"):
                lin = attn.to_out[0] if proj == "to_out" else getattr(attn, proj)
                w = (r.standard_normal(tuple(lin.weight.shape)) / np.sqrt(lin.in_features))
                lin.weight.copy_(torch.from_numpy(w.astype(np.float32)))
                tree[name][proj] = {"kernel": w.T.astype(np.float32)}
                if lin.bias is not None:
                    b = (r.standard_normal(lin.out_features) * 0.1).astype(np.float32)
                    lin.bias.copy_(torch.from_numpy(b))
                    tree[name][proj]["bias"] = b
    return block, tree


def test_precat_attention_matches_jax():
    """Self-attention through ``wqkv``, cross-attention through ``wkv``, and
    ``attn1`` called with a context (the banked READ pass over ``[h;
    bank]``, which concatenates its K/V at call time on both sides) against
    JAX's ``cross_attn_apply`` on the precat tree; the fused weights are
    JAX's transposed."""
    block, tree = _block_pair()
    jt = JU.precat_attention_weights(tree)
    assert set(jt["attn1"]) - set(tree["attn1"]) == {"wqkv"}
    assert set(jt["attn2"]) - set(tree["attn2"]) == {"wkv"}
    assert precat_attention_weights(block) is block
    np.testing.assert_array_equal(block.attn1.wqkv.detach().numpy(), np.asarray(jt["attn1"]["wqkv"]).T)
    np.testing.assert_array_equal(block.attn2.wkv.detach().numpy(), np.asarray(jt["attn2"]["wkv"]).T)
    assert block.attn1.wkv is None and block.attn2.wqkv is None
    r = np.random.default_rng(4)
    x = r.standard_normal((2, 16, 32)).astype(np.float32)
    ctx = r.standard_normal((2, 77, 24)).astype(np.float32)
    bank = np.concatenate([x, r.standard_normal((2, 16, 32)).astype(np.float32)], axis=1)
    cases = (("attn1", x, None), ("attn2", ctx, ctx), ("attn1", bank, bank))
    for name, jctx, pctx in cases:
        want = np.asarray(JU.cross_attn_apply(jt[name], jnp.asarray(x),
                                              jnp.asarray(x) if pctx is None else jnp.asarray(jctx),
                                              num_heads=4, impl="xla"))
        args = [torch.from_numpy(x)] + ([] if pctx is None else [torch.from_numpy(pctx)])
        with torch.no_grad():
            got = getattr(block, name)(*args).numpy()
        assert _rel(got, want) <= REL, (name, _rel(got, want))


@pytest.mark.parametrize("name", ["unet", "controlnet"])
def test_precat_model_matches_jax_and_the_port_without_it(bundle, name):
    """The tiny UNet and ControlNet with precat on both sides, against JAX
    at 1e-4 relative, and bit for bit the port's own forward without
    precat.  Every transformer block gained one ``wqkv`` and one ``wkv``."""
    _, trees = bundle
    a = _inputs()
    plain = _port(name, trees[name])
    before = _run_port(name, plain, a)
    fused = precat_attention_weights(_port(name, trees[name]))
    blocks = sum(isinstance(m, BasicTransformerBlock) for m in fused.modules())
    keys = _fused(fused)
    assert blocks > 0 and len(keys) == 2 * blocks
    assert sum(k.endswith(".attn1.wqkv") for k in keys) == blocks
    want = _run_jax(name, JU.precat_attention_weights(trees[name]), a)
    got = _run_port(name, fused, a)
    assert len(got) == len(want) == len(before)
    for g, wnt, b in zip(got, want, before):
        assert _rel(g, wnt) <= REL, _rel(g, wnt)
        np.testing.assert_array_equal(g, b)
    assert max(np.abs(w).max() for w in want) > 0.01


# ------------------------------------------------------------------ int8


def test_precat_skips_int8_attentions(bundle):
    """Quantized attentions (``min_attn_dim=64``: the 64-wide blocks in
    int8, the 32-wide ones plain) get no fused weight on either side, the
    plain ones do; an int8 attention after precat matches JAX's w8a8 one."""
    _, trees = bundle
    jq = JU.precat_attention_weights(JQ.quantize_transformer_linears(trees["unet"],
                                                                     min_attn_dim=64))
    unet = UNet2DConditionModel(CFG).eval()
    PQ.quantize_transformer_linears(unet, min_attn_dim=64)
    unet.load_state_dict(PW.state_dict_from_jax(jq, PW.unet_plan(CFG)), strict=True)
    precat_attention_weights(unet)

    def jax_fused(node, path=()):
        if isinstance(node, dict):
            out = {path + (k,) for k in ("wqkv", "wkv") if k in node}
            for k, v in node.items():
                out |= jax_fused(v, path + (k,))
            return out
        if isinstance(node, list):
            return set().union(*[jax_fused(v, path + (str(i),)) for i, v in enumerate(node)])
        return set()

    want = {".".join(p) for p in jax_fused(jq)}
    got = set(_fused(unet))
    attn2 = {p for p in want if p.endswith("attn2.wkv")}
    assert 0 < len(got) < 2 * sum(isinstance(m, BasicTransformerBlock) for m in unet.modules())
    # JAX's path names the same modules as the port's keys, but for the
    # transformer blocks' list (JAX "transformer_blocks", the port too)
    assert {k.replace(".wqkv", "").replace(".wkv", "") for k in got} == {
        k.replace(".wqkv", "").replace(".wkv", "") for k in want}
    assert attn2 and len(got) == len(want)
    for m in unet.modules():
        if isinstance(m, Attention):
            assert isinstance(m.to_q, LinearW8A8) == (m.wqkv is None and m.wkv is None)

    # one quantized attention pair, fused on neither side
    block, tree = _block_pair(seed=5)
    jt = JU.precat_attention_weights(
        {k: {n: JL.quantize_linear(jax.tree.map(jnp.asarray, p)) for n, p in v.items()}
         for k, v in tree.items()})
    PQ.quantize_transformer_linears(block, min_attn_dim=0)
    precat_attention_weights(block)
    assert "wqkv" not in jt["attn1"] and "wkv" not in jt["attn2"]
    assert block.attn1.wqkv is None and block.attn2.wkv is None
    x = np.random.default_rng(6).standard_normal((2, 16, 32)).astype(np.float32)
    want = np.asarray(JU.cross_attn_apply(jt["attn1"], jnp.asarray(x), jnp.asarray(x),
                                          num_heads=4, impl="xla"))
    with torch.no_grad():
        got = block.attn1(torch.from_numpy(x)).numpy()
    assert _rel_l2(got, want) < INT8_REL


# ------------------------------------------------------------------ gradients


def test_precat_gradients_match_jax_grad():
    """One transformer block (self-, cross-attention, GEGLU) differentiated
    on the precat tree: the ``wqkv``/``wkv`` gradients match ``jax.grad``'s,
    ``attn1``'s ``to_q``/``to_k``/``to_v`` and ``attn2``'s ``to_k``/``to_v``
    get none on both sides (JAX: zeros; the port: no gradient), and
    ``attn2.to_q`` matches."""
    block, tree = _block_pair(seed=7)
    r = np.random.default_rng(8)
    with torch.no_grad():
        for name, p in block.named_parameters():
            if name.startswith(("norm", "ff")):
                scale = 1.0 if name.startswith("norm") and name.endswith("weight") else 0.0
                p.copy_(torch.from_numpy(
                    (r.standard_normal(tuple(p.shape)) * 0.2 + scale).astype(np.float32)))
    sd = {k: v.numpy() for k, v in block.state_dict().items()}
    jtree = {**tree,
             **{n: {"scale": sd[f"{n}.weight"], "bias": sd[f"{n}.bias"]}
                for n in ("norm1", "norm2", "norm3")},
             "ff": {"proj": {"kernel": sd["ff.net.0.proj.weight"].T,
                             "bias": sd["ff.net.0.proj.bias"]},
                    "out": {"kernel": sd["ff.net.2.weight"].T, "bias": sd["ff.net.2.bias"]}}}
    jtree = JU.precat_attention_weights(jax.tree.map(jnp.asarray, jtree))
    x = r.standard_normal((2, 16, 32)).astype(np.float32)
    ctx = r.standard_normal((2, 77, 24)).astype(np.float32)
    g = r.standard_normal((2, 16, 32)).astype(np.float32)
    jcfg = J_UNET["tiny"]

    def loss(p):
        out = JU.transformer_block_apply(p, jcfg, jnp.asarray(x), jnp.asarray(ctx), num_heads=4)
        return jnp.sum(out * g)

    jg = jax.grad(loss)(jtree)
    precat_attention_weights(block)
    block.requires_grad_(True)
    out = block(torch.from_numpy(x), torch.from_numpy(ctx))
    (out * torch.from_numpy(g)).sum().backward()
    pairs = [(block.attn1.wqkv.grad, jg["attn1"]["wqkv"]),
             (block.attn2.wkv.grad, jg["attn2"]["wkv"]),
             (block.attn2.to_q.weight.grad, jg["attn2"]["to_q"]["kernel"]),
             (block.attn1.to_out[0].weight.grad, jg["attn1"]["to_out"]["kernel"])]
    for got, want in pairs:
        assert got is not None
        assert _rel(got.numpy(), np.asarray(want).T) <= REL, _rel(got.numpy(), np.asarray(want).T)
    for name, projs in (("attn1", ("to_q", "to_k", "to_v")), ("attn2", ("to_k", "to_v"))):
        for proj in projs:
            assert getattr(getattr(block, name), proj).weight.grad is None
            assert not np.asarray(jg[name][proj]["kernel"]).any()


# ------------------------------------------------------------------ checkpoints


def test_checkpoint_holds_only_the_plan_keys(bundle, tmp_path):
    """``save_bundle`` of a precat bundle writes exactly the plan's keys (the
    fused weights stay out, as JAX's plan export leaves them out), equal to
    the bundle's originals; ``state_dict_from_jax`` of a precat JAX tree is
    the state dict of the tree without precat."""
    b, trees = bundle
    fused = ModelBundle.random("tiny", dtype=torch.float32, device="cpu")
    for name in PLANS:
        fused.models[name].load_state_dict(b.models[name].state_dict())
        precat_attention_weights(fused.models[name])
        assert _fused(fused.models[name])
    save_bundle(fused, str(tmp_path))
    for name, (pplan, _) in PLANS.items():
        tensors = read_safetensors(os.path.join(tmp_path, f"{name}.safetensors"))
        plan_keys = [tk for _, tk, _ in pplan(CFG)]
        assert list(tensors) == plan_keys
        sd = b.models[name].state_dict()
        for k in plan_keys:
            np.testing.assert_array_equal(tensors[k], sd[k].numpy())
        ours = PW.state_dict_from_jax(JU.precat_attention_weights(trees[name]), pplan(CFG))
        theirs = PW.state_dict_from_jax(trees[name], pplan(CFG))
        assert list(ours) == list(theirs)
        for k in ours:
            assert torch.equal(ours[k], theirs[k]), k


# ------------------------------------------------------------------ tensor parallelism


def test_param_spec_of_fused_weights_follows_jax(bundle):
    """``param_spec`` answers for every ``wqkv``/``wkv`` as JAX's rule does
    for the tree's leaf, with the dims swapped for the [out, in] layout."""
    _, trees = bundle
    unet = precat_attention_weights(_port("unet", trees["unet"]))
    keys = sorted(_fused(unet))
    flat, _ = jax.tree_util.tree_flatten_with_path(JU.precat_attention_weights(trees["unet"]))
    jaxs = {}
    for path, _ in flat:
        names = [str(getattr(p, "key", getattr(p, "idx", p))) for p in path]
        if names[-1] in ("wqkv", "wkv"):
            jaxs[".".join(names)] = tuple(JM.param_spec(tuple(DictKey(n) for n in names), None))
    assert sorted(jaxs) == keys
    for k in keys:
        assert jaxs[k] == (None, "model")
        assert param_spec(k) == jaxs[k][::-1] == ("model", None), k


def test_tp2_precat_unet_equals_single_device(bundle):
    """A precat tiny UNet placed over (4 × 2) ``cpu`` slots: each rank's
    fused weight is the concatenation of its own q, k and v rows (not a
    contiguous cut), the placed forward equals the placed forward without
    precat bit for bit, and the single-device forward within 1e-6."""
    _, trees = bundle
    plain = _port("unet", trees["unet"])
    fused = precat_attention_weights(_port("unet", trees["unet"]))
    mesh = make_mesh(devices=CPU8, model_parallel=2)
    placed = shard_params({"unet": fused}, mesh)[0].models["unet"]
    placed_plain = shard_params({"unet": plain}, mesh)[0].models["unet"]
    whole = dict(fused.named_parameters())
    layers = [(n, m) for n, m in placed.named_modules()
              if isinstance(m, TensorParallel) and isinstance(m.shards[0], Attention)]
    assert layers
    for name, layer in layers:
        fused_name = "wqkv" if name.endswith("attn1") else "wkv"
        parts = ("to_q", "to_k", "to_v") if fused_name == "wqkv" else ("to_k", "to_v")
        inner = whole[f"{name}.to_q.weight"].shape[0]
        for r, shard in enumerate(layer.shards):
            own = slice(r * inner // 2, (r + 1) * inner // 2)
            want = torch.cat([whole[f"{name}.{p}.weight"][own] for p in parts])
            assert torch.equal(getattr(shard, fused_name), want)
            assert not torch.equal(want, whole[f"{name}.{fused_name}"][
                r * want.shape[0]:(r + 1) * want.shape[0]])
    a = _inputs(seed=9)
    got = _run_port("unet", placed, a)[0]
    np.testing.assert_array_equal(got, _run_port("unet", placed_plain, a)[0])
    assert _rel(got, _run_port("unet", plain, a)[0]) <= 1e-6
