"""The port's subprocess warm-up (config ``compile_subprocess``,
``runtime/engine_warmup.py::_warm_spec_subprocess``,
``tools/warm_spec.py``) and its ahead-of-boot tool (``tools/warm_cache.py``):
the counterparts of ``tests/test_server.py::
test_warm_spec_subprocess_cache_handoff`` and ``tests/test_tools.py``'s
two ``warm_cache`` cases, on a tiny fp32 CPU engine.  No JAX: the JAX
cases are orchestration, and the port's is held to the same contract."""

import dataclasses
import json
import logging
import os
import subprocess
import threading

import pytest
import torch

from videosd_tpu_torch.config import ServerConfig
from videosd_tpu_torch.pipelines.lcm_img2img import FrameSpec
from videosd_tpu_torch.runtime import engine_warmup
from videosd_tpu_torch.runtime.engine import Engine
from videosd_tpu_torch.tools import warm_cache, warm_spec

# One torch thread per process, set at import: every xdist worker imports
# every test module, and torch threads on every core of every worker stall
# JAX's interpreted Pallas kernels in the worker that runs them.
torch.set_num_threads(1)

SPEC = FrameSpec(batch=1, height=32, width=32, in_height=32, in_width=32, steps=1)
JOIN_S = 60.0


def _config(**kw) -> ServerConfig:
    return ServerConfig(family="tiny", dtype="float32", weights="random", frame_hw=(32, 32),
                        batch_buckets=(1,), **kw)


def test_warm_spec_subprocess_then_in_process(caplog):
    """With ``compile_subprocess``, the child (``tools/warm_spec.py``) builds
    the same engine on the parent's device, runs the spec once and exits 0:
    True, its JSON line logged; the in-process warm-up after it registers
    the spec.  An unbuildable request (``batch=0``) returns False, not
    raises."""
    engine = Engine(_config(compile_subprocess=True), max_streams=2, frame_hw=(32, 32),
                    device="cpu")
    caplog.set_level(logging.INFO, logger="videosd_tpu_torch.engine")
    assert engine._warm_spec_subprocess(SPEC, ref_mode=False) is True
    warmed = [r for r in caplog.records if r.msg.startswith("subprocess-warmed")]
    assert len(warmed) == 1
    child = json.loads(warmed[0].args[-1])
    assert child["device"] == "cpu" and child["ref_mode"] is False
    assert child["spec"] == dataclasses.asdict(SPEC)
    assert child["init_s"] >= 0 and child["warm_s"] >= 0
    engine._warm_spec(SPEC, ref_mode=False)
    assert (SPEC, False) in engine._ready_specs

    bad = FrameSpec(batch=0, height=32, width=32, steps=1)
    assert engine._warm_spec_subprocess(bad, ref_mode=False) is False


@pytest.mark.parametrize("flag,child_ok", [(True, True), (True, False), (False, True)])
def test_background_warm_runs_the_child_only_when_asked(flag, child_ok):
    """``_compile_spec_background`` runs the child first when
    ``compile_subprocess`` is on, then the in-process warm-up whether the
    child succeeded or not (the fall-through); with the setting off, the
    in-process warm-up alone."""
    engine = Engine(_config(compile_subprocess=flag), max_streams=2, frame_hw=(32, 32),
                    device="cpu")
    calls = []
    done = threading.Event()

    def child(spec, *, ref_mode):
        calls.append(("child", spec, ref_mode))
        return child_ok

    def warm(spec, *, ref_mode):
        calls.append(("warm", spec, ref_mode))
        done.set()

    engine._warm_spec_subprocess = child
    engine._warm_spec = warm
    engine._compile_spec_background(None, SPEC, True)
    assert done.wait(JOIN_S)
    for t in list(engine._bg_threads):
        t.join(JOIN_S)
        assert not t.is_alive()
    want = ([("child", SPEC, True)] if flag else []) + [("warm", SPEC, True)]
    assert calls == want
    assert (SPEC, True) not in engine._compiling


def test_child_wait_has_a_timeout(monkeypatch, caplog):
    """The parent waits for the child at most ``WARM_CHILD_TIMEOUT_S``; a
    child past it is a False (logged), and the request file is removed."""
    engine = Engine(_config(compile_subprocess=True), max_streams=2, frame_hw=(32, 32),
                    device="cpu")
    seen = {}

    def run(cmd, **kw):
        seen.update(kw, cmd=cmd)
        with open(cmd[-1]) as f:
            seen["req"] = json.load(f)
        raise subprocess.TimeoutExpired(cmd, kw["timeout"])

    monkeypatch.setattr(subprocess, "run", run)
    assert engine._warm_spec_subprocess(SPEC, ref_mode=True) is False
    assert seen["timeout"] == engine_warmup.WARM_CHILD_TIMEOUT_S > 0
    assert seen["cmd"][1:4] == ["-m", "videosd_tpu_torch.tools.warm_spec", "--json"]
    assert not os.path.exists(seen["cmd"][-1])
    req = seen["req"]
    assert req["device"] == "cpu" and req["ref_mode"] is True
    assert req["cfg"]["compile"] is False and req["cfg"]["compile_subprocess"] is False
    assert req["cfg"]["frame_hw"] == [32, 32] and req["cfg"]["input_format"] == "rgb"
    assert "timed out" in caplog.text


def test_child_without_a_card_exits_nonzero(tmp_path, monkeypatch):
    """A child asked for ``cuda`` where no card is visible exits non-zero
    before it builds anything: it never runs on the CPU."""
    req = tmp_path / "req.json"
    req.write_text(json.dumps({"cfg": dataclasses.asdict(_config()),
                               "spec": dataclasses.asdict(SPEC), "ref_mode": False,
                               "device": "cuda:0"}))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(Engine, "__init__", lambda *a, **kw: pytest.fail("engine built"))
    with pytest.raises(SystemExit) as e:
        warm_spec.main(["--json", str(req)])
    assert e.value.code not in (0, None)


def test_warm_cache_warms_each_bucket_step_pair(tmp_path, monkeypatch, capsys):
    cfg = tmp_path / "config.yaml"
    cfg.write_text(
        "family: tiny\nweights: random\nbatch_buckets: [2, 1, 2]\n"
        "frame_hw: [32, 32]\n"
    )
    calls = []

    def fake_init(self, config, **kw):
        self.config = config
        self._bundle = "loaded"
        calls.append(kw)

    def fake_warmup(self, batch_sizes=(1,), steps=(4,), **kw):
        calls.append((tuple(batch_sizes), tuple(steps)))

    monkeypatch.setattr(Engine, "__init__", fake_init)
    monkeypatch.setattr(Engine, "warmup", fake_warmup)

    warm_cache.main(["--config", str(cfg), "--steps", "2", "4", "--device", "cpu"])

    # dedup + sort of buckets, one warmup per (bucket, step) signature, as
    # Engine.warmup's own loop
    assert calls == [{"device": "cpu"}, ((1,), (2,)), ((1,), (4,)), ((2,), (2,)), ((2,), (4,))]
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(report["buckets"]) == {"b1_s2", "b1_s4", "b2_s2", "b2_s4"}
    assert report["total_s"] >= 0 and report["init_s"] >= 0
    lib = report["kernel_library"]
    assert os.path.dirname(lib).endswith(os.path.join("videosd_tpu_torch", "_build"))
    assert report["kernel_library_built"] == os.path.isfile(lib)


def test_warm_cache_cn_interval_flag(tmp_path, monkeypatch):
    """--cn-interval threads through to Engine.warmup so the warmed programs
    match what option_defaults streams will request."""
    cfg = tmp_path / "c.yaml"
    cfg.write_text("family: tiny\ndtype: float32\nbatch_buckets: [1]\n")
    seen = []

    def fake_warmup(self, batch_sizes=(1,), steps=(4,), cn_interval=None, **kw):
        seen.append((tuple(batch_sizes), tuple(steps), cn_interval, str(self.device)))

    monkeypatch.setattr(Engine, "warmup", fake_warmup)
    warm_cache.main(["--config", str(cfg), "--cn-interval", "4", "--device", "cpu"])
    assert seen == [((1,), (4,), 4, "cpu")]
