"""Live camera traffic: the scene, the camera clocks and the track's submit rule.

A traffic mix is a JSON file in ``benchmark/traffic/`` (``kind: camera``):

* ``streams``: how many cameras, each one stream of the engine;
* ``camera_hw``: the frames' [height, width], RGB;
* ``fps``: [low, high]: the streams' rates are evenly spaced over it (the
  middle for one stream), dealt to the streams in an order drawn from the
  seed, so every seed has the same set of rates;
* ``jitter_ms``: each tick lands uniformly within ± this of its due time;
* ``lead_in_s``: seconds the cameras run before the measured window (its
  frames warm the cohort and are not measured);
* ``prompts``: one per stream, dealt in an order drawn from the seed.

Each camera sees its own moving synthetic scene: a smooth coloured field
with sharp-edged shapes (so the edge detector has work), panned along a
closed path, with a bright square crossing it: a new picture every tick,
made from the seed, the stream and the tick alone, so the reference can
make any served frame again.

The client follows the live track's rule (``server/webrtc.py::recv``): on
each tick it submits the tick's frame if the stream's previous submit has
resolved, and otherwise drops the frame at the track.  So one frame per
stream is in flight, and its latency is timed from its tick's due time.
"""

from __future__ import annotations

import asyncio
import dataclasses
import math
import time

import numpy as np

__all__ = ["Cameras", "Tick", "percentile", "run_clients"]


class Scene:
    """One camera's picture source (see the module docstring)."""

    PAN = 64  # pixels of pan in each direction

    def __init__(self, rng: np.random.Generator, hw: tuple[int, int]):
        h, w = hw
        H, W = h + 2 * self.PAN, w + 2 * self.PAN
        yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
        field = np.zeros((H, W, 3), np.float32)
        for c in range(3):
            for _ in range(3):
                fy, fx = rng.uniform(0.5, 4.0, 2) * 2 * math.pi / np.array([H, W])
                field[..., c] += np.sin(fy * yy + fx * xx + rng.uniform(0, 2 * math.pi))
        field = 128.0 + 40.0 * field
        for _ in range(12):  # sharp-edged rectangles and discs
            cy, cx = rng.uniform(0, H), rng.uniform(0, W)
            r = rng.uniform(0.03, 0.12) * min(H, W)
            colour = rng.uniform(0, 255, 3).astype(np.float32)
            if rng.uniform() < 0.5:
                mask = (np.abs(yy - cy) < r) & (np.abs(xx - cx) < 1.6 * r)
            else:
                mask = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
            field[mask] = colour
        self.bg = np.clip(field, 0, 255).astype(np.uint8)
        self.hw = hw
        self.phase = rng.uniform(0, 2 * math.pi, 3)

    def frame(self, tick: int) -> np.ndarray:
        h, w = self.hw
        a = 2 * math.pi * tick / 300.0
        dy = int(round(self.PAN * (1 + math.sin(a + self.phase[0]))))
        dx = int(round(self.PAN * (1 + math.sin(2 * a + self.phase[1]))))
        out = self.bg[dy:dy + h, dx:dx + w].copy()
        s = max(8, min(h, w) // 8)
        y = int((h - s) * (0.5 + 0.5 * math.sin(3 * a + self.phase[2])))
        x = (tick * 7) % max(1, w - s)
        out[y:y + s, x:x + s] = 240
        return out


@dataclasses.dataclass
class Tick:
    """One submitted frame: its stream, tick and due time (perf_counter
    seconds), and, once resolved, when and with what."""

    stream: int
    tick: int
    due: float
    submitted: float = 0.0
    resolved: float | None = None
    image: np.ndarray | None = None
    latents: object = None  # the program's denoised latents of this frame
    fresh: bool = False  # a new generation (not a passed-through older output)


class Cameras:
    """The cameras of one traffic mix under one seed."""

    def __init__(self, traffic: dict, seed: int):
        rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, 1])
        n = int(traffic["streams"])
        lo, hi = traffic["fps"]
        rates = [0.5 * (lo + hi)] if n == 1 else list(np.linspace(lo, hi, n))
        self.rates = [float(rates[i]) for i in rng.permutation(n)]
        self.phases = [float(rng.uniform(0.0, 1.0 / r)) for r in self.rates]
        prompts = traffic["prompts"]
        self.prompts = [prompts[i % len(prompts)] for i in rng.permutation(n)]
        self.seeds = [int(s) for s in rng.integers(0, 2**31 - 1, n)]
        self.jitter_s = float(traffic["jitter_ms"]) / 1e3
        self._jitter_seed = int(rng.integers(0, 2**63 - 1))
        self.hw = tuple(traffic["camera_hw"])
        self.scenes = [Scene(np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, 2, i]),
                             self.hw) for i in range(n)]

    def due(self, stream: int, tick: int, t0: float) -> float:
        """Tick ``tick``'s due time on stream ``stream``'s clock, from ``t0``."""
        j = np.random.default_rng([self._jitter_seed, stream, tick]).uniform(-1.0, 1.0)
        return t0 + self.phases[stream] + tick / self.rates[stream] + j * self.jitter_s

    def frame(self, stream: int, tick: int) -> np.ndarray:
        return self.scenes[stream].frame(tick)


async def run_clients(cameras: Cameras, submit, t0: float, t_end: float, ticks: list,
                      drops: list, late: list) -> None:
    """Run every camera from ``t0`` until ``t_end`` (perf_counter seconds):
    each tick's frame goes to ``await submit(stream, frame, record)`` if the
    stream's previous submit has resolved, else it is dropped.  Appends each
    submitted :class:`Tick` to ``ticks``, each dropped (stream, tick, due) to
    ``drops`` and each tick's lateness (wake-up minus due, s) to ``late``;
    returns once every submit has resolved."""

    async def camera(stream: int):
        pending, tick = None, 0
        while True:
            due = cameras.due(stream, tick, t0)
            if due >= t_end:
                break
            delay = due - time.perf_counter()
            if delay > 0:
                await asyncio.sleep(delay)
            now = time.perf_counter()
            late.append((due, now - due))
            if pending is None or pending.done():
                rec = Tick(stream, tick, due, submitted=now)
                ticks.append(rec)
                pending = asyncio.ensure_future(submit(stream, cameras.frame(stream, tick), rec))
            else:
                drops.append((stream, tick, due))
            tick += 1
        if pending is not None:
            await pending

    await asyncio.gather(*(camera(i) for i in range(len(cameras.rates))))


def percentile(values, q: float) -> float:
    """The q-th percentile of all of ``values`` (linear interpolation between
    order statistics, as ``numpy.percentile``)."""
    if not values:
        raise ValueError("no samples")
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))
