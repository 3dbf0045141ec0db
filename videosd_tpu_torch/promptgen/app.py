"""Prompt-generator sidecar — same /llama-chat surface as the reference.

The reference runs FastAPI + langserve + LlamaCpp (diffusert/promptgen.py):
a GGUF Llama-2 chat model with a system prompt that turns a subject into a
styled image prompt (~30 tokens, temperature 5, top_k 60,
promptgen.py:25-46), exposed as a langserve route ``/llama-chat`` that the
client calls via ``RemoteRunnable.invoke({text})``
(client/src/lib/pages/home/index.tsx:20-23, 370).

This implementation keeps the langserve wire format
(``POST /llama-chat/invoke`` with ``{"input": {"text": ...}}`` ->
``{"output": ...}``) on aiohttp (fastapi/langserve are not in this image)
with a pluggable backend:

* ``TransformersBackend`` — any local causal LM (HF cache, CPU), driving
  the reference's EXACT chain shape: Llama-2 chat formatting with the
  reference's system prompt + 1-shot example turn (promptgen.py:38-56)
  and the reference's sampling (temperature 5, top_k 60, top_p 1,
  max 30 new tokens — promptgen.py:30-35);
* ``TemplateBackend``    — dependency-free deterministic stylizer used
  when no local model exists (zero-egress default).

``--model auto`` discovers any cached causal LM under the HF hub cache
(the same way io/discovery resolves diffusion snapshots) and falls back
to the template backend when none exists.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import logging
import random

from aiohttp import web

logger = logging.getLogger("videosd_tpu_torch.promptgen")

__all__ = [
    "create_app",
    "TemplateBackend",
    "TransformersBackend",
    "build_llama2_chat_prompt",
    "discover_causal_lm",
    "main",
]

# The reference's system prompt and 1-shot example, reproduced verbatim —
# they ARE the public behavior of /llama-chat (diffusert/promptgen.py:38-56;
# deliberate category-(b) reproduction, like the config keys).
SYSTEM_PROMPT = """
    I want you to act as a image prompt generator program.
    The user will provide you with a subject. You will add style keywords to the subject.
    If the user provides style keywords in input, ignore them, but use the same subject.
    You can use any art style, for example modern, ancient, primitive, western or eastern.
    Feel free to add artists names at the end.
    You will only answer with an image description, no chat.
    Keep your response within 20 words and answer without using quotes.
"""

# (human, assistant) example turns preceding the user's message
ONE_SHOT = [
    (
        "A landscape",
        "A painting of a landscape, a valley of a battlefield, caos around "
        "the mirror, realistic, well done, detailed, 8k",
    )
]

# LlamaCpp sampling parameters from the reference (promptgen.py:30-35)
SAMPLING = {"max_new_tokens": 30, "temperature": 5.0, "top_k": 60, "top_p": 1.0}


def build_llama2_chat_prompt(
    text: str,
    *,
    system: str = SYSTEM_PROMPT,
    examples: list[tuple[str, str]] = None,
) -> str:
    """Render the reference's chat chain into the Llama-2 chat wire format.

    Matches langchain_experimental's ``Llama2Chat`` rendering of
    [SystemMessage, HumanMessage, AIMessage, Human("{text}")]
    (the reference's ``template_messages``, promptgen.py:49-56):

        <s>[INST] <<SYS>>\\n{system}\\n<</SYS>>\\n\\n{human1} [/INST] {ai1} </s>
        <s>[INST] {human2} [/INST]
    """
    if examples is None:
        examples = ONE_SHOT
    turns = examples + [(text, None)]
    out = []
    for i, (human, ai) in enumerate(turns):
        user = human
        if i == 0:
            user = f"<<SYS>>\n{system}\n<</SYS>>\n\n{human}"
        if ai is None:
            out.append(f"<s>[INST] {user} [/INST]")
        else:
            out.append(f"<s>[INST] {user} [/INST] {ai} </s>")
    return "".join(out)


def discover_causal_lm(cache: str | None = None) -> str | None:
    """Newest cached HF snapshot whose config declares a causal-LM
    architecture (mirrors io/discovery.find_snapshot's cache walk)."""
    import glob
    import os

    cache = cache or os.environ.get(
        "HF_HUB_CACHE", os.path.expanduser("~/.cache/huggingface/hub")
    )
    best: tuple[float, str] | None = None
    for cfg_path in glob.glob(os.path.join(cache, "models--*", "snapshots", "*", "config.json")):
        try:
            with open(cfg_path) as f:
                cfg = json.load(f)
        except (OSError, ValueError):
            continue
        archs = cfg.get("architectures") or []
        if any("ForCausalLM" in a for a in archs):
            mt = os.path.getmtime(cfg_path)
            if best is None or mt > best[0]:
                best = (mt, os.path.dirname(cfg_path))
    return best[1] if best else None

_STYLES = [
    "pixar, cg, 3d render",
    "oil painting, impressionist, thick brushstrokes",
    "cyberpunk, neon lighting, rain, blade runner",
    "watercolor, soft pastel tones, paper texture",
    "ukiyo-e woodblock print, edo period",
    "film noir, dramatic shadows, black and white",
    "vaporwave, retrofuturism, chrome, sunset gradient",
    "studio ghibli, anime, lush scenery",
    "renaissance portrait, chiaroscuro, oil on canvas",
    "low poly, isometric, pastel palette",
    "steampunk, brass, gears, victorian",
    "comic book, halftone, bold ink outlines",
]

_DETAILS = [
    "highly detailed",
    "volumetric lighting",
    "8k",
    "sharp focus",
    "cinematic composition",
    "trending on artstation",
    "golden hour",
    "dramatic atmosphere",
    "intricate texture",
    "depth of field",
]


class TemplateBackend:
    """Deterministic subject -> styled prompt expansion (no model files)."""

    def generate(self, text: str, *, seed: int | None = None) -> str:
        subject = text.strip().rstrip(".") or "a scene"
        if seed is None:
            seed = int.from_bytes(hashlib.sha256(subject.encode()).digest()[:4], "little")
        rng = random.Random(seed)
        style = rng.choice(_STYLES)
        details = ", ".join(rng.sample(_DETAILS, 3))
        return f"{subject}, {style}, {details}"


class TransformersBackend:
    """Local causal LM via transformers (CPU), running the reference's
    exact chain: Llama-2 chat prompt (system + 1-shot example,
    promptgen.py:38-56) with the reference's sampling (temperature 5,
    top_k 60, top_p 1, 30 new tokens — promptgen.py:30-35)."""

    def __init__(self, model_path: str, *, sampling: dict | None = None):
        from transformers import AutoModelForCausalLM, AutoTokenizer

        self.tokenizer = AutoTokenizer.from_pretrained(model_path)
        self.model = AutoModelForCausalLM.from_pretrained(model_path)
        self.sampling = dict(SAMPLING if sampling is None else sampling)

    def build_prompt(self, text: str) -> str:
        return build_llama2_chat_prompt(text)

    def generate(self, text: str, *, seed: int | None = None) -> str:
        import torch

        if seed is not None:
            torch.manual_seed(seed)
        ids = self.tokenizer(self.build_prompt(text), return_tensors="pt").input_ids
        out = self.model.generate(
            ids,
            max_new_tokens=int(self.sampling["max_new_tokens"]),
            do_sample=True,
            temperature=float(self.sampling["temperature"]),
            top_k=int(self.sampling["top_k"]),
            top_p=float(self.sampling["top_p"]),
            pad_token_id=self.tokenizer.pad_token_id
            or self.tokenizer.eos_token_id,
        )
        gen = self.tokenizer.decode(out[0, ids.shape[1]:], skip_special_tokens=True)
        return gen.strip().split("\n")[0]


async def invoke(request: web.Request) -> web.Response:
    """langserve-compatible invoke endpoint.

    Body: {"input": {"text": "subject"}, "config": {...}} ->
    {"output": <string or {"text": ...}>, "metadata": {...}}.
    """
    backend = request.app["backend"]
    body = await request.json()
    inp = body.get("input", {})
    text = inp.get("text", "") if isinstance(inp, dict) else str(inp)
    result = backend.generate(text)
    return web.json_response(
        {"output": {"text": result}, "metadata": {"run_id": None, "feedback_tokens": []}}
    )


async def stream(request: web.Request) -> web.StreamResponse:
    """langserve stream endpoint (server-sent events with one chunk —
    enough for RemoteRunnable.stream clients)."""
    backend = request.app["backend"]
    body = await request.json()
    inp = body.get("input", {})
    text = inp.get("text", "") if isinstance(inp, dict) else str(inp)
    result = backend.generate(text)
    resp = web.StreamResponse(headers={"Content-Type": "text/event-stream"})
    await resp.prepare(request)
    await resp.write(b"event: data\ndata: " + json.dumps({"text": result}).encode() + b"\n\n")
    await resp.write(b"event: end\ndata: \n\n")
    return resp


async def healthz(request: web.Request) -> web.Response:
    return web.json_response({"ok": True})


@web.middleware
async def cors_middleware(request: web.Request, handler):
    resp = web.Response() if request.method == "OPTIONS" else await handler(request)
    resp.headers["Access-Control-Allow-Origin"] = "*"
    resp.headers["Access-Control-Allow-Headers"] = "*"
    resp.headers["Access-Control-Allow-Methods"] = "*"
    return resp


def create_app(backend=None) -> web.Application:
    app = web.Application(middlewares=[cors_middleware])
    app["backend"] = backend or TemplateBackend()
    app.router.add_post("/llama-chat/invoke", invoke)
    app.router.add_post("/llama-chat/stream", stream)
    app.router.add_get("/healthz", healthz)
    return app


def main(argv=None):
    parser = argparse.ArgumentParser(description="videosd_tpu_torch promptgen sidecar")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument(
        "--model",
        help="local causal LM dir, or 'auto' to discover one in the HF "
        "cache (else template backend)",
    )
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    model = args.model
    if model == "auto":
        model = discover_causal_lm()
        logger.info("discovered causal LM: %s", model or "none (template backend)")
    backend = TransformersBackend(model) if model else TemplateBackend()
    web.run_app(create_app(backend), host=args.host, port=args.port)


if __name__ == "__main__":
    main()
