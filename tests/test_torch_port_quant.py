"""The port's int8 w8a8 linears (``models/layers.py``, ``ops/quant.py``)
against the JAX package's (fp32, CPU): the counterparts of
``tests/test_quant.py``'s cases, each on the same seeded numpy inputs on
both sides.

Bars: the quantization (``w8``, ``sw``), the activation codes and one
linear's output are equal bit for bit (both divide truly, round half to
even and sum the int8 products exactly); a forward through attention,
a UNet or a ControlNet followed layer by layer is within 1e-3 relative
L2 of JAX's quantized forward, and left to run free within 1e-2 (their
fp32 sums differ in order, ~1e-7, so an activation that lands within that
of a rounding tie may take the other code, and later layers carry it on).  Weights
are a random tiny port bundle's, converted by JAX's own plans (the
ControlNet's output convs filled with random values) and cross through ``state_dict_from_jax``,
which also carries JAX's quantized trees.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from videosd_tpu.io import weights as JW
from videosd_tpu.models import layers as JL
from videosd_tpu.models import unet as JU
from videosd_tpu.models.controlnet import controlnet_apply as j_cn
from videosd_tpu.models.unet import UNET_PRESETS as J_UNET
from videosd_tpu.models.unet import BankReader as JBank
from videosd_tpu.models.unet import cross_attn_apply, cross_attn_init, unet_init
from videosd_tpu.models.unet import unet_apply as j_unet
from videosd_tpu.models.controlnet import controlnet_init
from videosd_tpu.ops import quant as JQ
from videosd_tpu_torch.config import ServerConfig
from videosd_tpu_torch.io import weights as PW
from videosd_tpu_torch.models import UNET_PRESETS, ControlNetModel, UNet2DConditionModel
from videosd_tpu_torch.models import controlnet_apply, unet_apply
from videosd_tpu_torch.models import layers as PL
from videosd_tpu_torch.models import unet as PU
from videosd_tpu_torch.models.layers import LinearW8A8, linear_w8a8, quantize_linear
from videosd_tpu_torch.models.unet import Attention, BankReader
from videosd_tpu_torch.ops import quant as PQ
from videosd_tpu_torch.ops.sobel import div_rn
from videosd_tpu_torch.pipelines.lcm_img2img import ModelBundle
from videosd_tpu_torch.runtime.engine import Engine

# One torch thread per process, set at import: every xdist worker imports
# every test module, and torch threads on every core of every worker stall
# JAX's interpreted Pallas kernels in the worker that runs them.
torch.set_num_threads(1)

CFG = UNET_PRESETS["tiny"]
j_w8a8, p_w8a8 = JL.linear_w8a8, linear_w8a8
KEY = jax.random.PRNGKey(7)
REL = 1e-3
# a free-running quantized forward against JAX's (see _follow_jax): one code
# that parts at a tie is carried on by every later quantized layer
FREE_REL = 1e-2
# how far from x.5 a code that parts from JAX's may lie, in steps of the
# scale: fp32 rounding of sums ~1e-7 relative, at codes up to 127
TIE = 1e-4


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _linear_params(rng, din, dout, bias=True):
    p = {"kernel": (rng.uniform(-1, 1, (din, dout)) / np.sqrt(din)).astype(np.float32)}
    if bias:
        p["bias"] = rng.standard_normal(dout).astype(np.float32) * 0.1
    return p


def _port_linear(p) -> nn.Linear:
    din, dout = p["kernel"].shape
    lin = nn.Linear(din, dout, bias="bias" in p)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(np.ascontiguousarray(p["kernel"].T)))
        if "bias" in p:
            lin.bias.copy_(torch.from_numpy(p["bias"]))
    return lin


@pytest.fixture(scope="module")
def jax_bundle():
    """The tiny UNet and ControlNet as JAX parameter trees (numpy leaves):
    a random port bundle's weights converted by JAX's own plans
    (``videosd_tpu/io/weights.py::convert``; JAX's initializers take ~10 s
    a model here), the ControlNet's zero-initialized output convs filled
    with random values."""
    bundle = ModelBundle.random("tiny", dtype=torch.float32, device="cpu")
    params = {name: jax.tree.map(np.asarray, JW.convert(
        {k: v.numpy() for k, v in bundle.models[name].state_dict().items()}, plan(J_UNET["tiny"])))
        for name, plan in (("unet", JW.unet_plan), ("controlnet", JW.controlnet_plan))}
    r = np.random.default_rng(11)
    cn = params["controlnet"]
    for zc in cn["controlnet_down_blocks"] + [cn["controlnet_mid_block"]]:
        zc["kernel"] = (r.standard_normal(zc["kernel"].shape) * 0.3).astype(np.float32)
        zc["bias"] = (r.standard_normal(zc["bias"].shape) * 0.1).astype(np.float32)
    return params


def _port(ctor, params, plan):
    mod = ctor().eval()
    mod.load_state_dict(PW.state_dict_from_jax(params, plan), strict=True)
    return mod


# ------------------------------------------------------------------ numerics


def test_weight_reconstruction_error_bounded():
    """``quantize_linear``: the same ``w8`` and ``sw`` as JAX's, bit for
    bit, and JAX's reconstruction bound."""
    p = _linear_params(np.random.default_rng(1), 64, 48)
    jq = JL.quantize_linear(jax.tree.map(jnp.asarray, p))
    q = quantize_linear(torch.from_numpy(p["kernel"].T.copy()), torch.from_numpy(p["bias"]))
    assert q["w8"].dtype == torch.int8 and q["sw"].shape == (48,)
    np.testing.assert_array_equal(q["w8"].numpy(), np.asarray(jq["w8"]).T)
    np.testing.assert_array_equal(q["sw"].numpy(), np.asarray(jq["sw"]))
    recon = q["w8"].numpy().astype(np.float32) * q["sw"].numpy()[:, None]
    col_max = np.abs(p["kernel"]).max(0)
    assert (np.abs(recon - p["kernel"].T) <= col_max[:, None] / 127.0 * 0.5 + 1e-7).all()


@pytest.mark.parametrize("shape,din,dout", [((4, 17, 96), 96, 64), ((4, 64, 320), 320, 1280)])
def test_linear_dispatches_on_w8_and_matches(shape, din, dout):
    """A ``LinearW8A8`` gives JAX's ``linear`` on the quantized params bit
    for bit (the activation codes too), close to the plain linear, bias
    carried."""
    rng = np.random.default_rng(2)
    p = _linear_params(rng, din, dout)
    x = rng.standard_normal(shape).astype(np.float32)
    jq = JL.quantize_linear(jax.tree.map(jnp.asarray, p))
    want = np.asarray(JL.linear(jq, jnp.asarray(x)))
    lin = _port_linear(p)
    mod = LinearW8A8.from_linear(lin)
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
        plain = lin(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    sx = np.maximum(np.abs(x).max(), np.float32(1e-6)) / np.float32(127.0)
    jcodes = np.asarray(jnp.clip(jnp.round(jnp.asarray(x) / sx), -127, 127).astype(jnp.int8))
    pcodes = torch.clamp(torch.round(torch.from_numpy(x) / torch.tensor(sx)), -127, 127)
    np.testing.assert_array_equal(pcodes.to(torch.int8).numpy(), jcodes)
    assert _rel(got, plain) < 0.02
    nobias = linear_w8a8(torch.from_numpy(x), mod.w8, mod.sw).numpy()
    assert np.abs(got - nobias).max() > 0  # the bias went through


def test_quantized_linear_handles_zero_input():
    p = _linear_params(np.random.default_rng(3), 8, 8, bias=False)
    want = np.asarray(JL.linear(JL.quantize_linear(jax.tree.map(jnp.asarray, p)), jnp.zeros((2, 8))))
    with torch.no_grad():
        got = LinearW8A8.from_linear(_port_linear(p))(torch.zeros(2, 8)).numpy()
    assert np.isfinite(got).all() and np.allclose(got, 0)
    np.testing.assert_array_equal(got, want)


def _attn_pair():
    """JAX's ``cross_attn_init(KEY, 32, 32, 32)`` quantized whole, and the
    port's ``Attention`` with the same projections quantized."""
    p = jax.tree.map(np.asarray, cross_attn_init(KEY, 32, 32, 32))
    jq = {k: JL.quantize_linear(jax.tree.map(jnp.asarray, v)) for k, v in p.items()}
    attn = Attention(32, 32, heads=4)
    for name in ("to_q", "to_k", "to_v"):
        setattr(attn, name, LinearW8A8.from_linear(_port_linear(p[name])))
    attn.to_out[0] = LinearW8A8.from_linear(_port_linear(p["to_out"]))
    plain = {k: jax.tree.map(jnp.asarray, v) for k, v in p.items()}
    return plain, jq, attn


def test_fused_qkv_quantized_self_attention_matches():
    plain, jq, attn = _attn_pair()
    x = np.random.default_rng(4).standard_normal((2, 16, 32)).astype(np.float32)
    want = np.asarray(cross_attn_apply(jq, jnp.asarray(x), jnp.asarray(x), num_heads=4, impl="xla"))
    ref = np.asarray(cross_attn_apply(plain, jnp.asarray(x), jnp.asarray(x), num_heads=4,
                                      impl="xla"))
    with torch.no_grad():
        got = attn(torch.from_numpy(x)).numpy()
    assert _rel(got, want) < REL
    assert _rel(got, ref) < 0.05


def test_fused_kv_quantized_banked_context_matches():
    """context is not x: the quantized fused K/V branch (the reference
    mode's READ pass over ``[h; bank]``), one activation scale over the
    whole context."""
    plain, jq, attn = _attn_pair()
    x = np.random.default_rng(5).standard_normal((2, 16, 32)).astype(np.float32)
    ctx = np.concatenate([x, x * 0.5], axis=1)
    want = np.asarray(cross_attn_apply(jq, jnp.asarray(x), jnp.asarray(ctx), num_heads=4,
                                       impl="xla"))
    ref = np.asarray(cross_attn_apply(plain, jnp.asarray(x), jnp.asarray(ctx), num_heads=4,
                                      impl="xla"))
    with torch.no_grad():
        got = attn(torch.from_numpy(x), torch.from_numpy(ctx)).numpy()
    assert _rel(got, want) < REL
    assert _rel(got, ref) < 0.05


# ------------------------------------------------------------------ walker


def _w8_keys(sd) -> set:
    return {k for k in sd if k.endswith(".w8")}


@pytest.mark.parametrize("min_attn_dim", [640, 0])
def test_walker_policy_ffn_always_attn_gated(jax_bundle, min_attn_dim):
    """The port's walker quantizes exactly the linears JAX's does, to the
    same ``w8``/``sw`` bit for bit: at tiny dims (32, 64) only the
    feed-forwards under the default policy, the attention too at
    ``min_attn_dim=0``, never the cross-attention's k/v."""
    want = PW.state_dict_from_jax(
        JQ.quantize_transformer_linears(jax_bundle["unet"], min_attn_dim=min_attn_dim),
        PW.unet_plan(CFG))
    unet = _port(lambda: UNet2DConditionModel(CFG), jax_bundle["unet"], PW.unet_plan(CFG))
    PQ.quantize_transformer_linears(unet, min_attn_dim=min_attn_dim)
    got = unet.state_dict()
    assert got.keys() == want.keys() and _w8_keys(got)
    for k, v in got.items():
        assert v.dtype == want[k].dtype, k
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), k)
    keys = _w8_keys(got)
    if min_attn_dim:
        assert all(".ff." in k for k in keys)
    else:
        assert any(".attn1." in k for k in keys)
        assert not any(".attn2.to_k" in k or ".attn2.to_v" in k for k in keys)


def test_walker_idempotent_and_leaf_sharing():
    unet = UNet2DConditionModel(CFG)
    conv_in = unet.conv_in
    PQ.quantize_transformer_linears(unet, min_attn_dim=0)
    first = {n: m for n, m in unet.named_modules() if isinstance(m, LinearW8A8)}
    PQ.quantize_transformer_linears(unet, min_attn_dim=0)
    again = {n: m for n, m in unet.named_modules() if isinstance(m, LinearW8A8)}
    assert first and first.keys() == again.keys()
    assert all(again[n] is m for n, m in first.items())  # left alone
    assert unet.conv_in is conv_in  # untouched modules are the same objects


@pytest.fixture(scope="module")
def unet_inputs():
    r = np.random.default_rng(6)
    x = r.standard_normal((2, 8, 8, 4)).astype(np.float32)
    t = np.array([999, 259], np.int32)
    ctx = r.standard_normal((2, 77, CFG.cross_attention_dim)).astype(np.float32)
    w = r.standard_normal((2, CFG.time_cond_proj_dim)).astype(np.float32)
    # a bank of the WRITE pass's shapes (one entry per transformer block)
    shapes = []
    unet = UNet2DConditionModel(CFG).eval()
    with torch.no_grad():
        unet_apply(unet, *(torch.from_numpy(a) for a in (x, t, ctx)),
                   timestep_cond=torch.from_numpy(w), bank_out=shapes)
    bank = [r.standard_normal(tuple(e.shape)).astype(np.float32) for e in shapes]
    return x, t, ctx, w, bank


def _codes(a):
    """``linear_w8a8``'s activation codes of ``a`` (the port's own steps)."""
    sx = div_rn(torch.clamp_min(a.abs().amax(), 1e-6), 127.0)
    return torch.clamp(torch.round(a / sx), -127, 127)


def _follow_jax(monkeypatch, run_jax, run_port):
    """JAX's quantized forward op by op (as tests/test_quant.py runs it:
    under jit XLA fuses the dequantize epilogue and may round it
    otherwise), every call of its ``linear_w8a8`` recorded; then the
    port's forward twice: free, its w8a8 inputs recorded, and following
    JAX layer by layer.  Following, every w8a8 call of the port must get an
    input within fp32 rounding of JAX's input to the same call (the n-th
    in order) and, on JAX's input, give JAX's output bit for bit (so each
    branch fuses the same weights and takes its scale over the same
    tensor); the forward goes on from that output.  Free, the first call
    whose activation codes differ from JAX's must have its input within
    fp32 rounding of JAX's: the codes part at a rounding tie, not at a
    branch.  Returns (JAX's output, the port's followed output, the calls)."""
    calls, free_in = [], []

    def record(p, a):
        y = j_w8a8(p, a)
        calls.append((np.array(a), np.array(y)))
        return y

    monkeypatch.setattr(JL, "linear_w8a8", record)
    monkeypatch.setattr(JU, "linear_w8a8", record)
    want = run_jax()

    def free(a, *rest):
        free_in.append(a.clone())
        return p_w8a8(a, *rest)

    steps = iter(calls)

    def follow(a, w8, sw, bias=None):
        ja, jy = (torch.from_numpy(v) for v in next(steps))
        assert a.shape == ja.shape and (a - ja).abs().max() <= 1e-5 * ja.abs().max()
        y = p_w8a8(ja, w8, sw, bias)
        assert torch.equal(y, jy)
        return y

    outs = []
    for fn in (free, follow):
        monkeypatch.setattr(PL, "linear_w8a8", fn)
        monkeypatch.setattr(PU, "linear_w8a8", fn)
        outs.append(run_port())
    assert next(steps, None) is None and len(free_in) == len(calls)  # every call was met
    for a, (ja, _) in zip(free_in, calls):
        ja = torch.from_numpy(ja)
        if not torch.equal(_codes(a), _codes(ja)):
            assert (a - ja).abs().max() <= 1e-5 * ja.abs().max()  # a tie, at fp32 rounding
            # every code that differs is one whose input lies at x.5 steps of
            # the scale, within fp32 rounding
            v = ja / div_rn(torch.clamp_min(ja.abs().amax(), 1e-6), 127.0)
            part = (v - torch.floor(v))[_codes(a) != _codes(ja)]
            print(f"first differing codes: {part.numel()}, fractional parts "
                  f"{part.min().item():.7f}..{part.max().item():.7f}")
            assert ((part - 0.5).abs() <= TIE).all()
            break
    return want, outs[1], outs[0], calls


@pytest.mark.parametrize("min_attn_dim", [640, 0])
def test_quantized_tiny_unet_forward_close(jax_bundle, unet_inputs, min_attn_dim, monkeypatch):
    """The tiny UNet quantized under each policy, in the reference mode's
    READ pass (fidelity 0.5): the banked self-attention over ``[h; bank]``,
    the plain self-attention and the cross-attention all run; followed
    layer by layer (:func:`_follow_jax`), within 1e-3 of JAX's forward.
    Left to run free, the port's forward is within FREE_REL of JAX's: 7.5e-7
    under the default policy, where no code parts, and 3.4e-3 at
    ``min_attn_dim=0``, where one activation lies within fp32 rounding of a
    rounding tie (9.5e-6 from x.5), the two take different codes there, and
    the quantized layers after it carry that code on."""
    x, t, ctx, w, bank = unet_inputs
    jq = JQ.quantize_transformer_linears(jax_bundle["unet"], min_attn_dim=min_attn_dim)
    unet = UNet2DConditionModel(CFG).eval()
    PQ.quantize_transformer_linears(unet, min_attn_dim=min_attn_dim)
    unet.load_state_dict(PW.state_dict_from_jax(jq, PW.unet_plan(CFG)), strict=True)

    def run_jax(p=jq):
        return np.asarray(j_unet(p, J_UNET["tiny"], *(jnp.asarray(a) for a in (x, t, ctx)),
                                 timestep_cond=jnp.asarray(w),
                                 bank=JBank([jnp.asarray(e) for e in bank], 0.5)))

    def run_port():
        with torch.no_grad():
            return unet_apply(unet, *(torch.from_numpy(a) for a in (x, t, ctx)),
                              timestep_cond=torch.from_numpy(w),
                              bank=BankReader([torch.from_numpy(e) for e in bank], 0.5)).numpy()

    want, got, free, calls = _follow_jax(monkeypatch, run_jax, run_port)
    print(f"free-running port against JAX: {_rel(free, want):.2e}")
    assert _rel(free, want) < FREE_REL
    # per block ff's 2, at min_attn_dim=0 also the banked 3, the plain 2 and
    # the cross-attention's 2
    assert len(calls) == (8 if min_attn_dim else 36)
    assert got.shape == want.shape
    assert _rel(got, want) < REL
    assert 0 < _rel(got, run_jax(jax_bundle["unet"])) < 0.05  # and int8 is not the plain net


@pytest.mark.parametrize("min_attn_dim", [640, 0])
def test_quantized_tiny_controlnet_forward_close(jax_bundle, unet_inputs, min_attn_dim,
                                                 monkeypatch):
    x, t, ctx, w, _ = unet_inputs
    cond = np.random.default_rng(7).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    scale = np.array([2.0, 0.5], np.float32)
    jq = JQ.quantize_transformer_linears(jax_bundle["controlnet"], min_attn_dim=min_attn_dim)
    cn = ControlNetModel(CFG).eval()
    PQ.quantize_transformer_linears(cn, min_attn_dim=min_attn_dim)
    cn.load_state_dict(PW.state_dict_from_jax(jq, PW.controlnet_plan(CFG)), strict=True)

    def run_jax():
        down, mid = j_cn(jq, J_UNET["tiny"], *(jnp.asarray(a) for a in (x, t, ctx, cond)),
                         conditioning_scale=jnp.asarray(scale), timestep_cond=jnp.asarray(w))
        return [np.asarray(r) for r in (*down, mid)]

    def run_port():
        with torch.no_grad():
            down, mid = controlnet_apply(
                cn, *(torch.from_numpy(a) for a in (x, t, ctx, cond)),
                conditioning_scale=torch.from_numpy(scale), timestep_cond=torch.from_numpy(w))
        return [r.numpy() for r in (*down, mid)]

    want, got, free, calls = _follow_jax(monkeypatch, run_jax, run_port)
    assert len(calls) == (4 if min_attn_dim else 12)  # 2 blocks: ff's 2, attention's 4
    assert len(got) == len(want) == len(free) == 5
    for g, f, wnt in zip(got, free, want):
        print(f"free-running port against JAX: {_rel(f, wnt):.2e}")
        assert _rel(g, wnt) < REL and _rel(f, wnt) < FREE_REL


def test_bundle_quantizer_skips_vae_and_clip():
    bundle = ModelBundle.random("tiny", dtype=torch.float32, device="cpu", with_kl_vae=True)
    clip, taesd = bundle.models["clip"], bundle.models["taesd"]
    before = {n: dict(m.state_dict()) for n, m in bundle.models.items()}
    PQ.quantize_bundle_params(bundle)
    for name in ("clip", "taesd", "vae"):
        assert PQ.quant_stats(bundle.models[name])["quantized_linears"] == 0
        assert all(torch.equal(v, before[name][k])
                   for k, v in bundle.models[name].state_dict().items())
    assert bundle.models["clip"] is clip and bundle.models["taesd"] is taesd
    for name in ("unet", "controlnet"):
        assert PQ.quant_stats(bundle.models[name])["quantized_linears"] > 0


@pytest.mark.parametrize("family", ["tiny", "tiny-xl", "sd15"])
def test_quant_stats_equal_jax(family):
    """``quant_stats`` of the UNet and ControlNet at the default policy, as
    JAX counts them (its trees under ``jax.eval_shape``; the port's models
    on the meta device)."""
    jcfg = J_UNET[family]
    for j_init, ctor in ((unet_init, UNet2DConditionModel), (controlnet_init, ControlNetModel)):
        tree = jax.eval_shape(lambda k: JQ.quantize_transformer_linears(j_init(k, jcfg)), KEY)
        with torch.device("meta"):
            model = ctor(UNET_PRESETS[family])
        PQ.quantize_transformer_linears(model)
        assert PQ.quant_stats(model) == JQ.quant_stats(tree), (family, ctor.__name__)


def test_state_dict_from_jax_carries_a_quantized_tree(jax_bundle):
    """JAX's quantized tree crosses into a quantized port model key for key:
    ``w8`` transposed to [out, in] int8, ``sw`` and biases fp32."""
    jq = JQ.quantize_transformer_linears(jax_bundle["unet"], min_attn_dim=0)
    sd = PW.state_dict_from_jax(jq, PW.unet_plan(CFG))
    k = "down_blocks.0.attentions.0.transformer_blocks.0.ff.net.0.proj"
    jp = jq["down_blocks"][0]["attentions"][0]["transformer_blocks"][0]["ff"]["proj"]
    assert sd[k + ".w8"].dtype == torch.int8 and k + ".weight" not in sd
    np.testing.assert_array_equal(sd[k + ".w8"].numpy(), np.asarray(jp["w8"]).T)
    np.testing.assert_array_equal(sd[k + ".sw"].numpy(), np.asarray(jp["sw"]))
    np.testing.assert_array_equal(sd[k + ".bias"].numpy(), np.asarray(jp["bias"]))


# ------------------------------------------------------------------ config / engine


def test_config_coercion():
    from videosd_tpu.config import ServerConfig as JConfig

    for raw in ({"quant": "INT8"}, {}):
        assert ServerConfig.from_dict(raw).quant == JConfig.from_dict(raw).quant
    assert ServerConfig.from_dict({"quant": "INT8"}).quant == "int8"
    with pytest.raises(ValueError):
        ServerConfig.from_dict({"quant": "fp4"})


def test_engine_applies_quant_to_bundle(jax_bundle):
    """``quant: int8`` quantizes the engine's UNet and ControlNet as JAX's
    engine quantizes its trees (the same counts), and ``stats()`` says so."""
    cfg = ServerConfig.from_dict({"family": "tiny", "dtype": "float32", "weights": "random",
                                  "quant": "int8"})
    eng = Engine(cfg, device="cpu")
    jq = JQ.quantize_bundle_params(jax_bundle)
    for name in ("unet", "controlnet"):
        got = PQ.quant_stats(eng.bundle.models[name])
        assert got["quantized_linears"] > 0 and got == JQ.quant_stats(jq[name])
    assert eng.stats()["quant"] == "int8"
