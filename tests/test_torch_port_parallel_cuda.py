"""More than one device on one card: meshes of repeated ``cuda:0`` slots.

The mesh's slots repeat ``cuda:0``, so one card runs every test: the
numerics, the partial sums, the launch counts and the placement record are
the real ones, and no traffic crosses cards.  Every test is marked
``cuda`` and skips without a card; the file imports neither JAX nor the JAX
package::

    python -m pytest --noconftest -m cuda tests/test_torch_port_parallel_cuda.py

* data parallelism: each row of a (2 x 1) mesh's frame equals, bit for
  bit, the single-device program run on that row alone; the replay equals
  the eager body;
* tensor parallelism on a (1 x 2) mesh: K1 launches twice per routed
  attention (two heads a rank on the tiny family's four), captured in the
  row's CUDA graph, and the replay equals eager bit for bit;
* the pipeline on one card: its frame equals the single-device program.
"""

import os

import numpy as np
import pytest
import torch

from videosd_tpu_torch.pipelines import lcm_img2img as P

CKPT = os.path.join(os.path.dirname(__file__), os.pardir, "examples", "toy_tiny_ckpt")
ARGS = ([0.6, 0.3], [5.0, 3.0], [2.0, 0.5])


@pytest.fixture(scope="module")
def tiny():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the mesh's slots are cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bundle = P.ModelBundle.from_dir(CKPT, device="cuda")
    embeds = P.build_prompt_encoder(bundle)(bundle.tokenizer(["a portrait", "a landscape"]))[0]
    return bundle, embeds


def _frames(seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)).cuda()


def _card(n):
    return [torch.device("cuda", 0)] * n


@pytest.mark.cuda
def test_data_rows_equal_single_device_rows(tiny):
    from videosd_tpu_torch.parallel.serving import ShardedFrameEngine

    bundle, embeds = tiny
    eng = ShardedFrameEngine(bundle, devices=_card(2))
    spec = P.FrameSpec(batch=2, height=128, width=128, steps=2)
    program = eng.program(spec)
    frame = _frames(1)
    got = program(frame, embeds, *ARGS, [11, 12])
    assert all(p.graphed for p in program.programs)
    one = P.build_frame_program(bundle, P.FrameSpec(batch=1, height=128, width=128, steps=2))
    for i in range(2):
        alone = one(frame[i:i + 1], embeds[i:i + 1], *([a[i]] for a in ARGS), [11 + i])
        assert torch.equal(alone[0], got[0][i:i + 1]) and torch.equal(alone[1], got[1][i:i + 1])
    (bucket,) = program.programs[1].buckets.values()
    with torch.inference_mode():
        eager = bucket.body(**bucket.buffers)
    replay = program(frame, embeds, *ARGS, [11, 12])
    assert torch.equal(replay[0][1:], eager[0]) and torch.equal(replay[1][1:], eager[1])


@pytest.mark.cuda
def test_tensor_parallel_launches_k1_per_rank(tiny):
    from videosd_tpu_torch.parallel.serving import ShardedFrameEngine

    bundle, embeds = tiny
    spec = P.FrameSpec(batch=2, height=128, width=128, steps=2)
    whole = P.build_frame_program(bundle, spec)
    want = whole(_frames(2), embeds, *ARGS, [3, 4])
    eng = ShardedFrameEngine(bundle, devices=_card(2), model_parallel=2)
    program = eng.program(spec)
    got = program(_frames(2), embeds, *ARGS, [3, 4])
    assert program.last_launches["flash_attention_fp32"] == (
        2 * whole.last_launches["flash_attention_fp32"])
    assert np.abs(got[0].cpu().numpy().astype(int) - want[0].cpu().numpy().astype(int)).max() <= 2
    torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-4)
    (bucket,) = program.programs[0].buckets.values()
    with torch.inference_mode():
        eager = bucket.body(**bucket.buffers)
    replay = program(_frames(2), embeds, *ARGS, [3, 4])
    assert torch.equal(replay[0], eager[0]) and torch.equal(replay[1], eager[1])


@pytest.mark.cuda
def test_pipeline_on_one_card_equals_single_device(tiny):
    from videosd_tpu_torch.parallel.pipe import PipelinedFrameEngine

    bundle, embeds = tiny
    spec = P.FrameSpec(batch=2, height=128, width=128, steps=2)
    want = P.build_frame_program(bundle, spec)(_frames(5), embeds, *ARGS, [7, 8])
    got = PipelinedFrameEngine(bundle, devices=_card(2)).run(spec, _frames(5), embeds, *ARGS,
                                                             [7, 8])
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
