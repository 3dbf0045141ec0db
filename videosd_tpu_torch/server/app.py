"""Session/API server over the port — the JAX server's surface on the card.

The port's counterpart of ``videosd_tpu/server/app.py``, with its routes
and flags:

* ``POST /offer``  — WebRTC SDP negotiation `{sdp, type, options}` ->
  `{sdp, type}`, gated on aiortc being installed (``server/webrtc.py``).
* ``/ws`` — the WebSocket frame transport (binary RGB24, I420 or JPEG frames
  in, ordered binary replies out, the options/prompt/record/audio/stats
  text messages).  Its per-connection logic is ``server/protocol.py``'s
  :class:`~videosd_tpu_torch.server.protocol.Session`; the handler here is
  the aiohttp loop that feeds it.
* ``/stats`` (engine/batcher/telemetry snapshot and the JPEG codec in use),
  ``/healthz``, ``/debug/engine``, ``/debug/memory``, ``/reload_weights``.
* ``POST /profile`` — a torch.profiler trace of N seconds, summarized by op
  and, with the engine's ``kernel_symbols()``, by model block.
* CLI flags --host/--port/--cert-file/--key-file/--config/-v, and
  ``--device`` (the card unless ``cpu`` is asked for); config.yaml,
  CORS-open responses, the 5-second watchdog.

Run: ``python -m videosd_tpu_torch.server.app --port 8080``.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import ssl
import tempfile

from aiohttp import WSMsgType, web

from videosd_tpu_torch.config import ServerConfig, load_config
from videosd_tpu_torch.runtime.engine import Engine
from videosd_tpu_torch.server.protocol import Session

logger = logging.getLogger("videosd_tpu_torch.server")

try:  # aiortc is optional in this image; the WebRTC path gates on it
    import aiortc  # noqa: F401

    HAVE_AIORTC = True
except Exception:  # pragma: no cover
    HAVE_AIORTC = False

__all__ = ["create_app", "main", "HAVE_AIORTC"]


@web.middleware
async def cors_middleware(request: web.Request, handler):
    """CORS-open responses (reference uses aiohttp_cors with *,
    server.py:307-313)."""
    if request.method == "OPTIONS":
        resp = web.Response()
    else:
        resp = await handler(request)
    resp.headers["Access-Control-Allow-Origin"] = "*"
    resp.headers["Access-Control-Allow-Headers"] = "*"
    resp.headers["Access-Control-Allow-Methods"] = "*"
    resp.headers["Access-Control-Allow-Credentials"] = "true"
    return resp


async def watchdog(app: web.Application):
    """5-second loop: session stats + stale-state recovery
    (reference server.py:323-349; its 'generating' flag reset maps to
    closing orphaned engine streams)."""
    engine: Engine = app["engine"]
    try:
        while True:
            sessions = len(app["sessions"])
            if sessions == 0:
                for sid in list(engine.streams):
                    engine.close_stream(sid)
            stats = engine.stats()
            logger.info(
                "watchdog: sessions=%d streams=%d ema=%.3fs dropped=%d",
                sessions,
                stats["streams"],
                stats["ema_gen_time"],
                stats["frames_dropped"],
            )
            await asyncio.sleep(5)
    except asyncio.CancelledError:
        pass


# ----------------------------------------------------------------- handlers


async def offer(request: web.Request) -> web.Response:
    """WebRTC signaling endpoint (same schema as server.py:145-264)."""
    if not HAVE_AIORTC:
        return web.json_response(
            {
                "error": "aiortc is not installed on this deployment; "
                "use the /ws transport"
            },
            status=501,
        )
    from videosd_tpu_torch.server.webrtc import handle_offer

    params = await request.json()
    answer = await handle_offer(request.app, params)
    return web.json_response(answer)


async def ws_handler(request: web.Request) -> web.WebSocketResponse:
    """WebSocket transport: the aiohttp loop over one
    :class:`~videosd_tpu_torch.server.protocol.Session` (its docstring has
    the protocol)."""
    ws = web.WebSocketResponse(max_msg_size=64 * 1024 * 1024)
    await ws.prepare(request)
    app = request.app
    app["sessions"].add(ws)

    async def send(payload):
        if isinstance(payload, bytes):
            await ws.send_bytes(payload)
        else:
            await ws.send_json(payload)

    session = Session(app["engine"], send, closed=lambda: ws.closed)
    try:
        async for msg in ws:
            if msg.type == WSMsgType.TEXT:
                await session.on_text(msg.data)
            elif msg.type == WSMsgType.BINARY:
                await session.on_binary(msg.data)
            elif msg.type == WSMsgType.ERROR:
                break
    finally:
        app["sessions"].discard(ws)
        session.close()
    return ws


async def stats_handler(request: web.Request) -> web.Response:
    from videosd_tpu_torch.runtime import jpegcodec

    stats = request.app["engine"].stats()
    stats["jpeg_codec"] = "native" if jpegcodec.native_available() else "pil"
    return web.json_response(stats)


async def healthz(request: web.Request) -> web.Response:
    return web.json_response({"ok": True})


async def profile_handler(request: web.Request) -> web.Response:
    """Capture a torch.profiler trace for N seconds (default 3, at most 30)
    into ``dir`` (default ``videosd_trace/`` in the temporary directory) and
    summarize it: device time by op and, unless ``symbols=0``, by model
    block (``unet/down0``, ``controlnet``, ...) through the engine's
    ``kernel_symbols()``."""
    seconds = float(request.query.get("seconds", 3))
    seconds = min(seconds, 30.0)
    log_dir = request.query.get("dir", os.path.join(tempfile.gettempdir(), "videosd_trace"))
    engine = request.app["engine"]
    await engine.start_trace(log_dir)
    await asyncio.sleep(seconds)
    await engine.stop_trace()
    body = {"trace_dir": log_dir, "seconds": seconds}
    if request.query.get("summary", "1") != "0":
        from videosd_tpu_torch.runtime.telemetry import summarize_trace

        loop = asyncio.get_running_loop()
        symbols = None
        if request.query.get("symbols", "1") != "0":
            # map each replayed kernel back to its model block by its
            # position in its program's kernel sequence
            symbols = await engine.kernel_symbols()
        body["summary"] = await loop.run_in_executor(
            None, lambda: summarize_trace(log_dir, symbols=symbols)
        )
    return web.json_response(body)


# ----------------------------------------------------------------- app


async def debug_engine_handler(request: web.Request) -> web.Response:
    """Runtime engine knobs: POST {"output_format": ..., "input_format":
    "rgb"|"i420"}.

    Ops aid for A/B-ing the wire formats live (no reboot).  The output
    flip is free — the I420 pack is a separate tiny jit and every
    consumer branches per-frame on the packed vs RGB layout.  The input
    flip re-keys the frame-program specs: the first bucket in the new
    layout background-compiles while streams get passthrough frames
    (same compile-stall-avoidance as any cold bucket).  GET returns the
    current values."""
    engine: Engine = request.app["engine"]
    if request.method == "POST":
        try:
            body = await request.json()
        except Exception:
            return web.json_response({"error": "bad json"}, status=400)
        fmt = body.get("output_format")
        if fmt is not None:
            fmt = str(fmt).lower()
            if fmt not in ("rgb", "i420"):
                return web.json_response(
                    {"error": f"output_format must be rgb|i420, got {fmt!r}"},
                    status=400,
                )
            engine.output_format = fmt
        in_fmt = body.get("input_format")
        if in_fmt is not None:
            try:
                engine.set_input_format(in_fmt)
            except ValueError as e:
                return web.json_response({"error": str(e)}, status=400)
    return web.json_response(
        {
            "output_format": engine.output_format,
            "input_format": engine.input_format,
        }
    )


async def reload_weights_handler(request: web.Request) -> web.Response:
    """Live checkpoint hot-swap: POST {"weights": "auto"|<dir>|<repo-id>,
    "controlnet": optional, "taesd": optional}.

    Loads the checkpoint off the event loop, then atomically swaps the
    serving params — zero dropped frames, zero recompiles (same family +
    dtype required; the engine rejects shape/dtype mismatches).  The
    reference must restart its Ray actors to change checkpoints; here the
    in-flight batch finishes on the old weights and the next batch runs
    the new ones.  GET returns the current weights provenance."""
    engine: Engine = request.app["engine"]
    if request.method != "POST":
        return web.json_response({"weights_source": engine.weights_source})
    try:
        body = await request.json()
    except Exception:
        return web.json_response({"error": "invalid JSON"}, status=400)
    setting = str(body.get("weights", "auto"))
    cfg = request.app["config"]

    def load():
        import torch

        from videosd_tpu_torch.io.discovery import resolve_weights
        from videosd_tpu_torch.pipelines.lcm_img2img import ModelBundle

        resolved = resolve_weights(
            body.get("model", getattr(cfg, "model", None)),
            controlnet=body.get("controlnet", getattr(cfg, "controlnet", None)),
            setting=setting,
        )
        if resolved is None:
            raise FileNotFoundError(
                f"weights: {setting!r} resolved to no checkpoint"
            )
        dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        loaded = ModelBundle.from_pretrained(
            resolved["model_dir"],
            family=cfg.family,
            controlnet_dir=resolved["controlnet_dir"],
            taesd_dir=body.get("taesd", resolved["taesd_dir"]),
            dtype=dtype,
            with_controlnet=True,
            device=engine.device,
        )
        # the serving bundle's models, as state dicts (swap_params checks
        # keys, shapes and dtypes, and refuses a model the snapshot lacks)
        serving = engine.bundle.models
        params = {n: m.state_dict() for n, m in loaded.models.items() if n in serving}
        return params, resolved

    try:
        params, resolved = await asyncio.get_running_loop().run_in_executor(
            None, load
        )
        engine.swap_params(params, source=resolved)
    except (FileNotFoundError, ValueError) as e:
        return web.json_response({"error": str(e)}, status=400)
    except Exception:
        logger.exception("weight reload failed")
        return web.json_response({"error": "load failed (see logs)"}, status=500)
    return web.json_response({"swapped": True, "weights_source": resolved})


async def debug_memory_handler(request: web.Request) -> web.Response:
    """Host-memory introspection: ?action=start|top|stop (tracemalloc).

    Ops aid for leak hunts on long-running servers; numpy buffers are
    tracked, native-library allocations are not."""
    import tracemalloc

    app = request.app
    action = request.query.get("action", "top")
    if action == "start":
        tracemalloc.start(10)
        app["_tm_base"] = tracemalloc.take_snapshot()
        return web.json_response({"ok": True})
    if action == "stop":
        tracemalloc.stop()
        app.pop("_tm_base", None)
        return web.json_response({"ok": True})
    if not tracemalloc.is_tracing():
        return web.json_response({"error": "not tracing; ?action=start first"})
    snap = tracemalloc.take_snapshot()
    base = app.get("_tm_base")
    stats = (
        snap.compare_to(base, "traceback") if base is not None
        else snap.statistics("traceback")
    )
    top = []
    for s in stats[:15]:
        size = getattr(s, "size_diff", None)
        size = s.size if size is None else size
        count = getattr(s, "count_diff", None)
        count = s.count if count is None else count
        top.append(
            {
                "kib": round(size / 1024, 1),
                "count": count,
                "where": s.traceback.format()[-2:],
            }
        )
    return web.json_response({"top": top})


async def _on_startup(app: web.Application):
    engine: Engine = app["engine"]
    engine.start()
    if engine.model_names:
        # resolve the `models:` registry off-loop at boot so the first
        # stream that selects one doesn't ride the default checkpoint
        # while it lazy-loads (engine._load_model_background)
        await asyncio.get_running_loop().run_in_executor(
            None, engine.load_models
        )
    if app["config"].compile:
        # AOT-warm the hot buckets so first frames don't hit compile stalls
        # (the reference's `compile` flag / compile_model warmup analog,
        # videopipeline.py:35-47, config.yaml:5).  Only the SMALLEST batch
        # bucket gates readiness — the rest warm in the background while
        # the server serves: a multi-stream group whose bucket isn't ready
        # is chunked onto the ready one by the engine's stall-avoidance
        # path, so time-to-first-frame stays ~1 warmup instead of N.
        loop = asyncio.get_running_loop()
        h = w = 512
        batches = sorted(
            b for b in app["config"].batch_buckets if b <= engine.max_batch
        ) or [1]
        await loop.run_in_executor(
            None,
            lambda: engine.warmup(
                batch_sizes=batches[:1], steps=(4,), height=h, width=w
            ),
        )
        from videosd_tpu_torch.pipelines.lcm_img2img import FrameSpec

        # warm the interval variant new streams will actually request
        # (config option_defaults), like Engine.warmup does
        defaults = app["config"].option_defaults or {}
        cn_interval = max(1, int(defaults.get("controlnet_interval", 1) or 1))
        dc_interval = max(1, int(defaults.get("deepcache_interval", 1) or 1))
        ih, iw = engine.frame_hw
        for b in batches[1:]:
            spec = FrameSpec(
                batch=b * engine.data_axis, height=h, width=w,
                in_height=ih, in_width=iw, steps=4,
                in_format=engine.input_format,
                controlnet_interval=cn_interval,
                deepcache_interval=dc_interval,
            )
            engine._compile_spec_background(loop, spec, ref_mode=False)
    app["watchdog_task"] = asyncio.get_running_loop().create_task(watchdog(app))


async def _on_shutdown(app: web.Application):
    # close peer connections + engine (reference on_shutdown, server.py:266-270)
    app["watchdog_task"].cancel()
    for closer in list(app.get("pc_closers", [])):
        await closer()
    await app["engine"].stop()


def create_app(config: ServerConfig | None = None, *, engine: Engine | None = None,
               device="cuda"):
    """The aiohttp app over ``engine``, or over a new engine of ``config``
    on ``device`` (the card unless the caller asks for the CPU)."""
    app = web.Application(middlewares=[cors_middleware])
    cfg = config or ServerConfig()
    app["config"] = cfg
    app["engine"] = engine or Engine(cfg, device=device)
    app["sessions"] = set()
    app["pc_closers"] = []
    app.router.add_post("/offer", offer)
    app.router.add_get("/ws", ws_handler)
    app.router.add_get("/stats", stats_handler)
    app.router.add_get("/healthz", healthz)
    app.router.add_post("/profile", profile_handler)
    app.router.add_get("/debug/memory", debug_memory_handler)
    app.router.add_route("*", "/debug/engine", debug_engine_handler)
    app.router.add_route("*", "/reload_weights", reload_weights_handler)

    # serve the bundled static client at / when present (production deploys
    # put nginx in front instead, like the reference's frontend container)
    client_dir = os.path.join(os.path.dirname(__file__), "..", "..", "client")
    client_dir = os.path.abspath(client_dir)
    if os.path.isdir(client_dir):

        async def index(_req):
            return web.FileResponse(os.path.join(client_dir, "index.html"))

        app.router.add_get("/", index)
        app.router.add_static("/client", client_dir)

        async def appjs(_req):
            return web.FileResponse(os.path.join(client_dir, "app.js"))

        app.router.add_get("/app.js", appjs)

        # service worker must be served from the root path so its scope
        # covers "/" (PWA app shell; client/sw.js)
        async def sw(_req):
            return web.FileResponse(os.path.join(client_dir, "sw.js"))

        app.router.add_get("/sw.js", sw)
    app.on_startup.append(_on_startup)
    app.on_shutdown.append(_on_shutdown)
    return app


def main(argv=None):
    parser = argparse.ArgumentParser(description="videosd_tpu_torch WebRTC/WS server")
    parser.add_argument("--cert-file", help="SSL certificate file (for HTTPS)")
    parser.add_argument("--key-file", help="SSL key file (for HTTPS)")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--config", default="config.yaml")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--verbose", "-v", action="count")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO)

    try:
        cfg = load_config(args.config)
    except FileNotFoundError:
        cfg = ServerConfig()

    ssl_context = None
    if args.cert_file:
        ssl_context = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ssl_context.load_cert_chain(args.cert_file, args.key_file)

    app = create_app(cfg, device=args.device)
    web.run_app(
        app, access_log=None, host=args.host, port=args.port, ssl_context=ssl_context
    )


if __name__ == "__main__":
    main()
