"""Meshes across processes over the port: a real two-process
``torch.distributed`` group on the CPU (``gloo`` on localhost), 4 CPU slots
a process, 8 in all (the counterpart of ``tests/test_multihost.py``'s
two-process ``jax.distributed`` cluster of 4 virtual CPU devices each).

One pair of processes runs three cases, each reported on its own:

* (a) JAX's psum case: ``init_distributed`` gives 8 slots, 4 local; the
  ("data", "model") = (4, 2) mesh over both processes; ``reduce_data`` of
  ``arange(8)`` laid over the data axis gives ``[12, 16]`` on both; a
  ``model_parallel`` whose row would span processes raises; a ``Mesh`` of
  each process's first slot (``processes=``) gives one row a process;
* (b) the serving program: tiny, 64^2, 2 steps.  On the (4 x 2) mesh at
  batch 4, each process's rows (``ShardedProgram.shards``, JAX's
  addressable shards) equal bit for bit the same rows of the one-process
  program on a (4 x 2) mesh of 8 local slots, and the single-device
  program's within one image level and 1e-4 in latents (a tensor-parallel
  row sums its ranks' partial outputs in another order); a plain call,
  which would return only this process's rows, raises.  On the (8 x 1)
  mesh at batch 8 each row equals the single-device program on that row
  alone, bit for bit;
* (c) the sharded train step (tiny, 16^2 latents, batch 8, AdamW) on the
  (4 x 2) mesh across the two processes against the one-process step on a
  (4 x 2) mesh of 8 local slots: gradients within 1e-5 of each tensor's
  largest, loss within 1e-6 relative, and both processes' weights equal
  after the step.

Every wait is bounded: the group's rendezvous and collectives
(``init_distributed(timeout=)``) and each process (``communicate``, killed
in ``finally``).
"""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = r"""
import dataclasses, sys, traceback
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
from videosd_tpu_torch.parallel import mesh as M
from videosd_tpu_torch.parallel.serving import ShardedFrameEngine
from videosd_tpu_torch.pipelines.lcm_img2img import (
    FrameSpec, ModelBundle, build_frame_program, build_prompt_encoder)
from videosd_tpu_torch.schedulers.lcm import LCMSchedulerConfig
from videosd_tpu_torch.train import optim
from videosd_tpu_torch.train import step as PT

coord, pid = sys.argv[1], int(sys.argv[2])
CPU = torch.device("cpu")
n = M.init_distributed(coord, num_processes=2, process_id=pid, devices=[CPU] * 4, timeout=60)
assert n == 8, n
assert M.world().backend == "gloo" and M.world().size == 2


def case(name, fn):
    try:
        fn()
        print(f"CASE_OK {name} {pid}", flush=True)
    except Exception:
        traceback.print_exc()
        print(f"CASE_FAIL {name} {pid}", flush=True)


def psum():
    mesh = M.make_mesh(8, model_parallel=2)
    assert mesh.shape == {"data": 4, "model": 2}
    assert mesh.spans_processes and mesh.local_rows() == [2 * pid, 2 * pid + 1]
    full = torch.arange(8.0)
    got = M.reduce_data([full[2 * i:2 * i + 2] for i in mesh.local_rows()], mesh)
    assert got.tolist() == [0 + 2 + 4 + 6, 1 + 3 + 5 + 7], got
    one_each = M.Mesh([slots[0] for slots in M.world().slots], processes=[0, 1])
    assert one_each.shape == {"data": 2, "model": 1} and one_each.local_rows() == [pid]
    try:
        M.make_mesh(8, model_parallel=8)
    except ValueError as e:
        assert "span processes" in str(e), e
    else:
        raise AssertionError("a model row across processes did not raise")


bundle = ModelBundle.random("tiny", dtype=torch.float32, device="cpu")


def _inputs(b):
    rng = np.random.default_rng(3)
    ctx, _ = build_prompt_encoder(bundle)(bundle.tokenizer([f"prompt {i}" for i in range(b)]))
    return (torch.from_numpy(rng.integers(0, 256, (b, 64, 64, 3), dtype=np.uint8)), ctx,
            np.linspace(0.4, 0.8, b).astype(np.float32), np.linspace(3.0, 6.0, b).astype(np.float32),
            np.linspace(0.5, 2.0, b).astype(np.float32), np.arange(9, 9 + b, dtype=np.int32))


def _alone(spec, args, rows):
    single = build_frame_program(bundle, dataclasses.replace(spec, batch=rows.stop - rows.start))
    return single(*(a[rows] for a in args))


def serving():
    spec = FrameSpec(batch=4, height=64, width=64, steps=2)
    args = _inputs(4)
    mesh = M.make_mesh(8, model_parallel=2)
    program = ShardedFrameEngine(bundle, mesh=mesh).program(spec)
    shards = program.shards(*args)
    try:
        program(*args)
    except RuntimeError as e:
        assert "shards(" in str(e), e
    else:
        raise AssertionError("a call over a mesh across processes returned part of the batch")
    one = ShardedFrameEngine(bundle, devices=[CPU] * 8, model_parallel=2).program(spec)(*args)
    assert [rows for rows, _ in shards] == [slice(2 * pid, 2 * pid + 1), slice(2 * pid + 1, 2 * pid + 2)]
    for rows, out in shards:
        for got, want in zip(out, one):
            assert torch.equal(got, want[rows]), rows
        img, lat = _alone(spec, args, rows)
        assert (out[0].int() - img.int()).abs().max() <= 1
        torch.testing.assert_close(out[1], lat, rtol=1e-4, atol=1e-4)
    spec8 = FrameSpec(batch=8, height=64, width=64, steps=2)
    args8 = _inputs(8)
    shards8 = ShardedFrameEngine(bundle, mesh=M.make_mesh(8)).program(spec8).shards(*args8)
    assert len(shards8) == 4
    for rows, out in shards8:
        for got, want in zip(out, _alone(spec8, args8, rows)):
            assert torch.equal(got, want), rows


def train():
    import copy

    unet0 = bundle.models["unet"]
    rng = np.random.default_rng(23)
    with torch.no_grad():
        for p in unet0.parameters():
            if not p.abs().max() > 0:
                p.copy_(torch.from_numpy(rng.normal(0, 0.05, p.shape).astype(np.float32)))
    cfg = bundle.unet_cfg
    batch = {"latents": torch.from_numpy(rng.standard_normal((8, 16, 16, 4)).astype(np.float32)),
             "context": torch.from_numpy(
                 rng.standard_normal((8, 77, cfg.cross_attention_dim)).astype(np.float32)),
             "w_cond": torch.from_numpy(
                 rng.standard_normal((8, cfg.time_cond_proj_dim)).astype(np.float32))}
    runs = []
    for mesh in (M.make_mesh(8, model_parallel=2), M.make_mesh(devices=[CPU] * 8, model_parallel=2)):
        unet = copy.deepcopy(unet0)
        state = PT.init_train_state(unet, optim.adamw(1e-3))
        loss = PT.make_train_step(LCMSchedulerConfig(), mesh=mesh)(
            state, batch, generator=torch.Generator().manual_seed(5))["loss"]
        runs.append((loss.item(), dict(unet.named_parameters())))
    (loss, got), (want_loss, want) = runs
    assert abs(loss - want_loss) <= 1e-6 * abs(want_loss), (loss, want_loss)
    for name, p in want.items():
        err = (got[name].grad - p.grad).abs().max().item()
        assert err <= 1e-5 * p.grad.abs().max().item(), (name, err)
    digest = [float(p.detach().double().sum()) for p in got.values()]
    both = [None, None]
    dist.all_gather_object(both, digest)
    assert both[0] == both[1], "the processes stepped their weights apart"


try:
    case("psum", psum)
    case("serving", serving)
    case("train", train)
finally:
    M.shutdown_distributed()
"""

CASES = ("psum", "serving", "train")
CHILD_S = 150


@pytest.fixture(scope="module")
def outputs():
    port = socket.socket()
    port.bind(("localhost", 0))
    addr = f"localhost:{port.getsockname()[1]}"
    port.close()
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, addr, str(i)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=CHILD_S)
            outs.append(out.decode())
    finally:
        # a TimeoutExpired above must not leak a worker (a peer waiting in a
        # collective would otherwise outlive the test run)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, out) for p, out in zip(procs, outs)]


@pytest.mark.parametrize("name", CASES)
def test_two_process_case(outputs, name):
    for i, (rc, out) in enumerate(outputs):
        assert rc == 0, f"process {i} exited {rc}:\n{out[-6000:]}"
        assert f"CASE_OK {name} {i}" in out, out[-6000:]
