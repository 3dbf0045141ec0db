"""The port's LoRA fusion (``videosd_tpu_torch/io/lora.py``) against the JAX
package's (``videosd_tpu/io/lora.py``), and the engine's ``lora`` and
``quant: int8`` wiring: the counterparts of ``tests/test_lora.py``'s cases.

Adapter files are written from seeded numpy tensors against the tiny UNet
(a random port UNet's weights as JAX's tree) in all three wire formats;
both sides read the same file and fuse it, and the port's fused state dict is held equal bit for bit to
``state_dict_from_jax`` of JAX's fused tree, in fp32 and in bf16.  The
engine cases build tiny fp32 bundles on the CPU.
"""

import asyncio
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videosd_tpu.io import lora as JLORA
from videosd_tpu.io import weights as JW
from videosd_tpu.models.unet import UNET_PRESETS as J_UNET
from videosd_tpu_torch.config import ServerConfig, normalize_lora_setting
from videosd_tpu_torch.io import lora as PLORA
from videosd_tpu_torch.io import weights as PW
from videosd_tpu_torch.io.safetensors import write_safetensors
from videosd_tpu_torch.models import UNET_PRESETS, UNet2DConditionModel, unet_apply
from videosd_tpu_torch.models.layers import LinearW8A8, quantize_linear
from videosd_tpu_torch.ops.quant import quant_stats
from videosd_tpu_torch.pipelines.lcm_img2img import FrameSpec, ModelBundle, build_frame_program
from videosd_tpu_torch.runtime.engine import Engine

# One torch thread per process, set at import: every xdist worker imports
# every test module, and torch threads on every core of every worker stall
# JAX's interpreted Pallas kernels in the worker that runs them.
torch.set_num_threads(1)

CFG = UNET_PRESETS["tiny"]
PLAN = PW.unet_plan(CFG)


@pytest.fixture(scope="module")
def jparams():
    """JAX's tiny UNet tree (numpy leaves): a random port UNet's weights
    converted by JAX's own plan (JAX's initializer takes ~10 s here)."""
    unet = ModelBundle.random("tiny", dtype=torch.float32, device="cpu").models["unet"]
    return jax.tree.map(np.asarray, JW.convert(
        {k: v.numpy() for k, v in unet.state_dict().items()}, JW.unet_plan(J_UNET["tiny"])))


def _linear_modules(plan, n=3):
    return [t[:-7] for _, t, k in plan if k == "linear" and t.endswith(".weight")][:n]


def _conv_modules(plan, n=1):
    return [t[:-7] for _, t, k in plan if k == "conv" and t.endswith(".weight")][:n]


def _make_entry(sd, module, rng, rank=4):
    """Seeded down/up halves for ``module`` of a torch-layout state dict."""
    w = sd[module + ".weight"]
    if w.ndim == 2:
        out_dim, in_dim = w.shape
        return (rng.standard_normal((rank, in_dim), dtype=np.float32) * 0.1,
                rng.standard_normal((out_dim, rank), dtype=np.float32) * 0.1)
    out_dim, in_dim, kh, kw = w.shape
    return (rng.standard_normal((rank, in_dim, kh, kw), dtype=np.float32) * 0.1,
            rng.standard_normal((out_dim, rank, 1, 1), dtype=np.float32) * 0.1)


def _tree(jparams, dtype):
    return jax.tree.map(lambda a: np.asarray(jnp.asarray(a, dtype)), jparams)


def _sd(tree, dtype):
    return {k: v.to(dtype) for k, v in PW.state_dict_from_jax(tree, PLAN).items()}


def _same_reads(path):
    """Both readers on one file: the same towers, modules and halves."""
    ours, theirs = PLORA.read_lora(path), JLORA.read_lora(path)
    assert ours.keys() == theirs.keys()
    for tower in ours:
        assert ours[tower].keys() == theirs[tower].keys()
        for m, e in ours[tower].items():
            t = theirs[tower][m]
            np.testing.assert_array_equal(e.down, t.down)
            np.testing.assert_array_equal(e.up, t.up)
            assert e.alpha == t.alpha and e.scaling() == t.scaling()
    return ours


# ------------------------------------------------------------------ parsing


def test_read_peft_format(tmp_path, jparams):
    sd = _sd(jparams, torch.float32)
    mod = _linear_modules(PLAN, 1)[0]
    down, up = _make_entry(sd, mod, np.random.default_rng(3))
    path = str(tmp_path / "peft.safetensors")
    write_safetensors(path, {f"unet.{mod}.lora_A.weight": down, f"unet.{mod}.lora_B.weight": up})
    towers = _same_reads(path)
    assert set(towers) == {"unet"} and set(towers["unet"]) == {mod}
    e = towers["unet"][mod]
    assert e.rank == 4 and e.alpha is None and e.scaling() == 1.0


def test_read_kohya_format_with_alpha(tmp_path, jparams):
    sd = _sd(jparams, torch.float32)
    mod = _linear_modules(PLAN, 1)[0]
    down, up = _make_entry(sd, mod, np.random.default_rng(4))
    koh = "lora_unet_" + mod.replace(".", "_")
    path = str(tmp_path / "kohya.safetensors")
    write_safetensors(path, {f"{koh}.lora_down.weight": down, f"{koh}.lora_up.weight": up,
                             f"{koh}.alpha": np.asarray(2.0, np.float32)})
    e = _same_reads(path)["unet"][mod.replace(".", "_")]
    assert e.alpha == 2.0 and e.scaling() == pytest.approx(0.5)  # alpha/r = 2/4


def test_read_legacy_processor_format(tmp_path):
    rng = np.random.default_rng(5)
    down = rng.standard_normal((4, 32), dtype=np.float32)
    up = rng.standard_normal((32, 4), dtype=np.float32)
    base = "mid_block.attentions.0.transformer_blocks.0"
    path = str(tmp_path / "legacy.safetensors")
    write_safetensors(path, {
        f"unet.{base}.processor.to_q_lora.down.weight": down,
        f"unet.{base}.processor.to_q_lora.up.weight": up,
        f"unet.{base}.processor.to_out_lora.down.weight": down,
        f"unet.{base}.processor.to_out_lora.up.weight": up,
    })
    towers = _same_reads(path)
    assert f"{base}.attn1.to_q" not in towers["unet"]  # processor keys don't invent attn1
    assert {f"{base}.to_q", f"{base}.to_out.0"} == set(towers["unet"])  # to_out_lora -> to_out.0


@pytest.mark.parametrize("tensors", [
    {"something.weird": np.zeros((2, 2), np.float32)},  # no known format
    {"unet.conv_in.lora_A.weight": np.zeros((4, 3), np.float32)},  # half a module
], ids=["unknown_keys", "half_modules"])
def test_read_rejects(tmp_path, tensors):
    path = str(tmp_path / "bad.safetensors")
    write_safetensors(path, tensors)
    for reader in (PLORA.read_lora, JLORA.read_lora):
        with pytest.raises(KeyError):
            reader(path)


# ------------------------------------------------------------------- fusion


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", ["peft", "legacy", "kohya", "conv"])
def test_fused_state_dict_equals_jax(tmp_path, jparams, fmt, dtype):
    """One file per wire format (and a conv LoRA), read and fused by both
    sides at scale 0.7: the port's fused state dict is
    ``state_dict_from_jax`` of JAX's fused tree, bit for bit, in the
    bundle's dtype; every other tensor is shared, not copied."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tree, sd = _tree(jparams, jdt), _sd(_tree(jparams, jdt), tdt)
    rng = np.random.default_rng(6)
    mods = _conv_modules(PLAN, 2) if fmt == "conv" else _linear_modules(PLAN, 40)[::8]
    tensors = {}
    for m in mods:
        down, up = _make_entry(sd, m, rng)
        if fmt == "kohya":
            koh = "lora_unet_" + m.replace(".", "_")
            tensors.update({f"{koh}.lora_down.weight": down, f"{koh}.lora_up.weight": up,
                            f"{koh}.alpha": np.asarray(2.0, np.float32)})
        elif fmt == "legacy":
            tensors.update({f"unet.{m}.lora.down.weight": down, f"unet.{m}.lora.up.weight": up})
        else:
            tensors.update({f"unet.{m}.lora_A.weight": down, f"unet.{m}.lora_B.weight": up})
    path = str(tmp_path / f"{fmt}.safetensors")
    write_safetensors(path, tensors)
    ours, unmatched = PLORA.fuse_lora(sd, PLAN, PLORA.read_lora(path)["unet"], scale=0.7)
    theirs, j_unmatched = JLORA.fuse_lora(tree, JW.unet_plan(J_UNET["tiny"]),
                                          JLORA.read_lora(path)["unet"], scale=0.7)
    assert unmatched == j_unmatched == []
    want = PW.state_dict_from_jax(jax.tree.map(np.asarray, theirs), PLAN)
    changed = {m + ".weight" for m in mods}
    for k, v in ours.items():
        assert v.dtype == tdt
        np.testing.assert_array_equal(v.float().numpy(), want[k].numpy(), err_msg=k)
        assert (v is sd[k]) == (k not in changed), k
        if k in changed:
            assert not torch.equal(v, sd[k]), k


def test_fuse_linear_math(jparams):
    sd = _sd(jparams, torch.float32)
    mod = _linear_modules(PLAN, 2)[1]
    down, up = _make_entry(sd, mod, np.random.default_rng(7))
    fused, unmatched = PLORA.fuse_lora(
        sd, PLAN, {mod: PLORA.LoRAEntry(down=down, up=up, alpha=2.0)}, scale=0.7)
    assert unmatched == []
    expect = sd[mod + ".weight"].numpy() + 0.7 * 0.5 * (up @ down)
    np.testing.assert_allclose(fused[mod + ".weight"].numpy(), expect, rtol=2e-5)


def test_fuse_conv_lora_layout(jparams):
    sd = _sd(jparams, torch.float32)
    mod = _conv_modules(PLAN, 1)[0]
    down, up = _make_entry(sd, mod, np.random.default_rng(8))
    fused, unmatched = PLORA.fuse_lora(sd, PLAN, {mod: PLORA.LoRAEntry(down=down, up=up)})
    assert unmatched == []
    delta = np.einsum("or,rikl->oikl", up[:, :, 0, 0], down)  # torch OIHW, no transpose
    np.testing.assert_allclose(fused[mod + ".weight"].numpy(), sd[mod + ".weight"].numpy() + delta,
                               rtol=2e-5)


def test_fuse_kohya_name_resolution(jparams):
    # underscore spelling (incl. to_out.0 -> to_out_0) resolves via the plan
    sd = _sd(jparams, torch.float32)
    mod = [m for m in _linear_modules(PLAN, 50) if m.endswith("to_out.0")][0]
    down, up = _make_entry(sd, mod, np.random.default_rng(9))
    entry = {mod.replace(".", "_"): PLORA.LoRAEntry(down=down, up=up)}
    fused, unmatched = PLORA.fuse_lora(sd, PLAN, entry)
    assert unmatched == []
    assert not torch.equal(fused[mod + ".weight"], sd[mod + ".weight"])


def test_fuse_untouched_leaves_shared(jparams):
    sd = _sd(jparams, torch.float32)
    mod = _linear_modules(PLAN, 1)[0]
    down, up = _make_entry(sd, mod, np.random.default_rng(10))
    fused, _ = PLORA.fuse_lora(sd, PLAN, {mod: PLORA.LoRAEntry(down=down, up=up)})
    assert fused["conv_in.weight"] is sd["conv_in.weight"]


def test_fuse_reports_unmatched(jparams):
    entry = {"no.such.module": PLORA.LoRAEntry(down=np.zeros((4, 8), np.float32),
                                               up=np.zeros((8, 4), np.float32))}
    _, unmatched = PLORA.fuse_lora(_sd(jparams, torch.float32), PLAN, entry)
    _, j_unmatched = JLORA.fuse_lora(jparams, JW.unet_plan(J_UNET["tiny"]),
                                     {k: JLORA.LoRAEntry(down=v.down, up=v.up)
                                      for k, v in entry.items()})
    assert unmatched == j_unmatched == ["no.such.module"]


def test_fuse_shape_mismatch_raises(jparams):
    mod = _linear_modules(PLAN, 1)[0]
    kw = dict(down=np.zeros((4, 5), np.float32), up=np.zeros((6, 4), np.float32))
    with pytest.raises(ValueError):
        PLORA.fuse_lora(_sd(jparams, torch.float32), PLAN, {mod: PLORA.LoRAEntry(**kw)})
    with pytest.raises(ValueError):
        JLORA.fuse_lora(jparams, JW.unet_plan(J_UNET["tiny"]), {mod: JLORA.LoRAEntry(**kw)})


def test_forward_changes_and_zero_scale_identity(jparams):
    sd = _sd(jparams, torch.float32)
    rng = np.random.default_rng(12)
    modules = {m: PLORA.LoRAEntry(*_make_entry(sd, m, rng)) for m in _linear_modules(PLAN, 3)}
    r = np.random.default_rng(13)
    x = torch.from_numpy(r.standard_normal((1, 16, 16, 4)).astype(np.float32))
    ctx = torch.from_numpy(r.standard_normal((1, 7, CFG.cross_attention_dim)).astype(np.float32))
    w = torch.zeros(1, CFG.time_cond_proj_dim)
    unet = UNet2DConditionModel(CFG).eval()

    def run(state):
        unet.load_state_dict(state, strict=True)
        with torch.no_grad():
            return unet_apply(unet, x, torch.tensor([500]), ctx, timestep_cond=w)

    y0 = run(sd)
    assert not torch.allclose(run(PLORA.fuse_lora(sd, PLAN, modules, scale=1.0)[0]), y0)
    assert torch.equal(run(PLORA.fuse_lora(sd, PLAN, modules, scale=0.0)[0]), y0)


# --------------------------------------------------------- config / engine


def test_normalize_lora_setting():
    """The config's copy of the normalizer (``config.py``) answers as
    JAX's on the same settings."""
    from videosd_tpu.io.lora import normalize_lora_setting as j_norm

    for setting, scale in ((None, 1.0), ("a.safetensors", 0.5),
                           (["a", {"path": "b", "scale": 2.0}, {"file": "c"}], 1.0)):
        assert normalize_lora_setting(setting, scale) == j_norm(setting, scale)
    assert normalize_lora_setting(["a", {"path": "b", "scale": 2.0}], 1.0) == [
        ("a", 1.0), ("b", 2.0)]
    for norm in (normalize_lora_setting, j_norm):
        with pytest.raises(ValueError):
            norm([{"scale": 1.0}])


def _base():
    return ModelBundle.random("tiny", dtype=torch.float32, device="cpu")


def _write_tiny_lora(tmp_path, base, *, n=2, name="tiny_lcm_lora.safetensors"):
    sd = base.models["unet"].state_dict()
    rng = np.random.default_rng(14)
    tensors = {}
    for m in _linear_modules(PLAN, n):
        down, up = _make_entry(sd, m, rng)
        tensors[f"unet.{m}.lora_A.weight"] = down
        tensors[f"unet.{m}.lora_B.weight"] = up
    path = str(tmp_path / name)
    write_safetensors(path, tensors)
    return path


def _engine(path, **extra):
    raw = {"family": "tiny", "dtype": "float32", "weights": "random", "lora": path,
           "frame_hw": (32, 32), **extra}
    return Engine(ServerConfig.from_dict(raw), max_streams=2, max_batch=1, deadline_ms=5,
                  device="cpu")


def test_engine_fuses_config_lora(tmp_path):
    """config ``lora`` + ``lora_scale`` fuse into the engine's own bundle,
    equal to ``fuse_lora`` of the same random base; a bundle built
    afterwards from the same seed is untouched."""
    base = _base()
    path = _write_tiny_lora(tmp_path, base)
    eng = _engine(path, lora_scale=0.5)
    assert eng.config.lora == [(path, 0.5)]
    sd = base.models["unet"].state_dict()
    want, _ = PLORA.fuse_lora(sd, PLAN, PLORA.read_lora(path)["unet"], scale=0.5)
    got = eng.bundle.models["unet"].state_dict()
    mod = _linear_modules(PLAN, 1)[0] + ".weight"
    assert torch.equal(got[mod], want[mod]) and not torch.equal(got[mod], sd[mod])
    assert all(torch.equal(v, want[k]) for k, v in got.items())
    assert torch.equal(_base().models["unet"].state_dict()[mod], sd[mod])


def test_engine_lora_then_quant_ordering(tmp_path):
    """LoRA fuses before int8: the quantized projection is
    ``quantize_linear`` of the fused weight; both levers show in stats."""
    base = _base()
    path = _write_tiny_lora(tmp_path, base, n=40)
    eng = _engine(path, quant="int8")
    unet = eng.bundle.models["unet"]
    assert quant_stats(unet)["quantized_linears"] > 0
    fused, _ = PLORA.fuse_lora(base.models["unet"].state_dict(), PLAN,
                               PLORA.read_lora(path)["unet"])
    prefix = "down_blocks.0.attentions.0.transformer_blocks.0.ff.net.0.proj"
    assert prefix in [m[:-len(".weight")] for m in fused if m in
                      {x + ".weight" for x in _linear_modules(PLAN, 40)}]
    q = quantize_linear(fused[prefix + ".weight"], fused[prefix + ".bias"])
    mod = unet.get_submodule(prefix)
    assert isinstance(mod, LinearW8A8)
    assert all(torch.equal(getattr(mod, k), v) for k, v in q.items())
    s = eng.stats()
    assert s["quant"] == "int8" and s["lora"] == [{"path": path, "scale": 1.0}]


def test_swap_params_refuses_lora(tmp_path):
    """A hot-swapped base checkpoint keeps the configured adapters and the
    int8 form: ``swap_params`` with the plain base state dicts re-fuses and
    re-quantizes, and the serving weights come back as they were."""
    base = _base()
    path = _write_tiny_lora(tmp_path, base)
    eng = _engine(path, quant="int8")
    before = {n: {k: v.clone() for k, v in m.state_dict().items()}
              for n, m in eng.bundle.models.items()}
    eng.swap_params({n: m.state_dict() for n, m in base.models.items()}, source="test")
    for n, m in eng.bundle.models.items():
        after = m.state_dict()
        assert after.keys() == before[n].keys()
        assert all(torch.equal(v, before[n][k]) for k, v in after.items()), n
    mod = _linear_modules(PLAN, 1)[0] + ".weight"
    assert not torch.equal(eng.bundle.models["unet"].state_dict()[mod],
                           base.models["unet"].state_dict()[mod])
    assert eng.weights_source == "test"


def test_bundle_lora_partial_tower_warns(tmp_path, caplog):
    bundle = _base()
    plan_te = PW.clip_plan(bundle.clip_cfg)
    te_mod = [t[:-7] for _, t, k in plan_te if k == "linear"][0]
    out_dim, in_dim = bundle.models["clip"].state_dict()[te_mod + ".weight"].shape
    rng = np.random.default_rng(15)
    tensors = {
        f"text_encoder.{te_mod}.lora_A.weight": rng.standard_normal((4, in_dim), dtype=np.float32),
        f"text_encoder.{te_mod}.lora_B.weight": rng.standard_normal((out_dim, 4), dtype=np.float32),
        # and a tower the bundle doesn't carry
        "text_encoder_2.text_projection.lora_A.weight": np.zeros((4, 8), np.float32),
        "text_encoder_2.text_projection.lora_B.weight": np.zeros((8, 4), np.float32),
    }
    path = str(tmp_path / "te.safetensors")
    write_safetensors(path, tensors)
    before = bundle.models["clip"].state_dict()[te_mod + ".weight"].clone()
    with caplog.at_level(logging.WARNING, logger="videosd_tpu_torch.lora"):
        stats = PLORA.fuse_bundle_loras(bundle, [(path, 1.0)])
    assert stats.get("text_encoder") == 1
    assert any("text_encoder_2" in r.message for r in caplog.records)
    assert not torch.equal(bundle.models["clip"].state_dict()[te_mod + ".weight"], before)
    with pytest.raises(KeyError, match="text_encoder_2"):
        PLORA.fuse_bundle_loras(_base(), [(path, 1.0)], strict=True)


def test_engine_lora_int8_frame_equals_frame_program(tmp_path, rng):
    """An engine with ``lora`` and ``quant: int8`` serves, through its
    frame program, the frame a direct ``build_frame_program`` call gives
    on a bundle fused and quantized the same way; a ``models:`` entry with
    its own ``lora`` loads in the same int8 form."""
    from videosd_tpu_torch.io.lora import fuse_bundle_loras
    from videosd_tpu_torch.ops.quant import quantize_bundle_params

    base = _base()
    path = _write_tiny_lora(tmp_path, base, n=40)
    alt = _write_tiny_lora(tmp_path, base, n=5, name="alt.safetensors")
    eng = _engine(path, quant="int8", models={"alt": {"model": "some/repo", "lora": alt}})
    frame = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)

    async def run():
        eng.start()
        try:
            st = eng.open_stream({"height": 32, "width": 32, "steps": 1})
            out = None
            for _ in range(40):
                before = eng.telemetry.frames_out
                out = await asyncio.wait_for(eng.submit_frame(st.stream_id, frame), 120)
                if eng.telemetry.frames_out > before:
                    return st, out
                await asyncio.sleep(0.1)
            raise TimeoutError("no generation")
        finally:
            await eng.stop()

    st, out = asyncio.run(run())
    fuse_bundle_loras(base, [(path, 1.0)])
    quantize_bundle_params(base)
    spec = FrameSpec(batch=1, height=32, width=32, in_height=32, in_width=32, steps=1)
    want, _ = build_frame_program(base, spec)(
        frame[None], eng._encode_prompt(st.options["prompt"])[0], [0.6], [5.0], [2.0],
        [st.options["seed"]], warm_latents=np.zeros((1, 4, 4, 4), np.float32),
        warm_alpha=[0.0], src_box=[[0, 0, 32, 32]])
    np.testing.assert_array_equal(out, want[0].numpy())
    extra = eng._extra_bundle("alt")
    assert quant_stats(extra.models["unet"]) == quant_stats(eng.bundle.models["unet"])
    assert extra.models["unet"].state_dict().keys() == eng.bundle.models["unet"].state_dict().keys()
