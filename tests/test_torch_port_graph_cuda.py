"""The frame program's CUDA graphs on the card.

``build_frame_program`` captures one CUDA graph per call signature at its
first call and replays it after.  A capture needs the card, so every test
here is marked ``cuda`` and skips without one.  The file imports neither
JAX nor the JAX package::

    python -m pytest --noconftest -m cuda tests/test_torch_port_graph_cuda.py

The committed tiny checkpoint runs in fp32 at 128x128, where its routed
attentions launch K1's fp32 kernel inside the graph; replays are held to
the eager ``frame_program`` bit for bit.  The last test makes a capture
fail on purpose, so it runs last.
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
        pytest.skip("needs a CUDA card: a CUDA graph is captured on the card")
    bundle = P.ModelBundle.from_dir(CKPT, device="cuda")
    embeds = P.build_prompt_encoder(bundle)(bundle.tokenizer(["a portrait", "a landscape"]))[0]
    return bundle, embeds


def _frames(seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("temporal", [False, True], ids=["parity", "temporal"])
def test_replay_equals_eager_on_card(tiny, temporal):
    bundle, embeds = tiny
    spec = P.FrameSpec(batch=2, height=128, width=128, steps=2, deepcache_temporal=temporal)
    program = P.build_frame_program(bundle, spec)
    calls = [(_frames(seed), [seed, seed + 1]) for seed in (1, 2)]
    outs = [program(frame, embeds, *ARGS, seeds) for frame, seeds in calls]
    assert program.last_launches["flash_attention_fp32"] > 0  # K1's fp32 kernel is in the graph
    assert program.last_launches["flash_attention"] == 0
    for out, (frame, seeds) in zip(outs, calls):
        want = P.frame_program(bundle, spec, frame, embeds, *ARGS, seeds)
        assert all(torch.equal(a, b) for a, b in zip(out, want))
    assert not torch.equal(outs[0][1], outs[1][1])
    if temporal:  # the reuse signature is a graph of its own
        out = program(calls[0][0], embeds, *ARGS, calls[0][1], deep_caches=outs[0][2])
        want = P.frame_program(bundle, spec, calls[0][0], embeds, *ARGS, calls[0][1],
                               deep_caches=outs[0][2])
        assert all(torch.equal(a, b) for a, b in zip(out, want))
        assert len(program.buckets) == 2


@pytest.mark.cuda
def test_capture_failure_names_the_hook_on_card(tiny):
    """A safety hook that reads a value back to the host cannot be captured:
    the program raises, naming the hook, and does not fall back to the
    eager program."""
    bundle, embeds = tiny

    def syncing_hook(images):
        return images * float(images.abs().max().item() > 0)

    hooked = P.ModelBundle(**{**vars(bundle), "safety_hook": syncing_hook})
    program = P.build_frame_program(hooked, P.FrameSpec(batch=2, height=64, width=64, steps=2))
    frame = _frames(3)[:, :64, :64].contiguous()
    with pytest.raises(RuntimeError, match="safety_hook.*syncing_hook"):
        program(frame, embeds, *ARGS, [1, 2])
