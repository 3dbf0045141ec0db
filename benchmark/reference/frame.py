"""Plain float32 reference of one served frame, from the camera frame to the
image: the crop and resize of the camera frame, the Sobel control image,
the prompt's tokens and text embeddings, the seeded noise, the TAESD
encode, the LCM ladder with the ControlNet and the UNet at every step, and
the TAESD decode.

It takes only what a client sends (the camera frame, the prompt, the
stream options, the seed) and the benchmark's own weights, and works out
everything else itself.  Where the served frame is defined by a rounding
rule (the lanczos3 taps, the luma's floor, the thresholds of the control
image), the same rule is written out here; the models run in float32 with
TF32 off.
"""

from __future__ import annotations

import contextlib
import hashlib
import html
import math
import re

import numpy as np
import torch

from benchmark.reference import models as M

# ------------------------------------------------------------------ precision


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32 (TF32 off) for the duration."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _div(x, d: float):
    """A true division (CUDA multiplies by the reciprocal of a Python float)."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


# ------------------------------------------------------------------ tokens

_WORD_RE = re.compile(r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
                      r"|[^\W\d_]+|\d|[^\s\w]+", re.IGNORECASE)


def tokenize(text: str, vocab_size: int, pad_to_eos: bool = True, length: int = 77):
    """[1, 77] int64 ids of a prompt with no vocabulary file: each word
    hashed (sha256) into the ids below the three specials, between the
    start and end tokens, padded with the end token.  A run of the
    benchmark has no vocabulary file, so the served program tokenizes so
    too."""
    bot, eot = (49406, 49407) if vocab_size >= 49408 else (vocab_size - 2, vocab_size - 1)
    text = re.sub(r"\s+", " ", html.unescape(html.unescape(text))).strip().lower()
    ids = [int.from_bytes(hashlib.sha256(w.encode()).digest()[:4], "little") % (vocab_size - 3)
           + 1 for w in _WORD_RE.findall(text)]
    row = [bot] + ids[:length - 2] + [eot]
    out = np.full((1, length), eot if pad_to_eos else 0, np.int64)
    out[0, :len(row)] = row
    return torch.from_numpy(out)


# ------------------------------------------------------------------ preprocess


def _lanczos3(x):
    ax = x.abs()
    safe = torch.where(ax < 1e-6, 1.0, math.pi * x)
    third = _div(safe, 3.0)
    val = torch.where(ax < 1e-6, 1.0, (torch.sin(safe) / safe) * (torch.sin(third) / third))
    return torch.where(ax < 3.0, val, 0.0)


def _resample(x, start: float, length: float, out_n: int):
    """Lanczos3 resample of x [N, ...] along dim 0 onto out_n samples of the
    source interval [start, start+length): taps clamped into the interval,
    the kernel stretched by the downscale (antialias)."""
    dev = x.device
    start = torch.tensor(float(start), device=dev)
    length = torch.tensor(float(length), device=dev)
    scale = _div(length, float(out_n))
    kscale = torch.clamp(scale, min=1.0)
    taps = int(np.ceil(6.0 * max(1.0, x.shape[0] / out_n))) + 2
    i = torch.arange(out_n, dtype=torch.float32, device=dev)
    centers = start + (i + 0.5) * scale - 0.5
    lo = torch.floor(centers - 3.0 * kscale) + 1.0
    idx = lo[:, None] + torch.arange(taps, dtype=torch.float32, device=dev)
    wts = _lanczos3((idx - centers[:, None]) / kscale)
    wts = wts / wts.sum(-1, keepdim=True)
    idx = torch.clamp(idx, start, start + length - 1.0).long().clamp(0, x.shape[0] - 1)
    return (x[idx] * wts.reshape(*wts.shape, *(1,) * (x.ndim - 1))).sum(1)


def center_crop_box(in_h: int, in_w: int, out_h: int, out_w: int):
    """(top, left, height, width) of the centered crop with the output's
    aspect ratio, with PIL's flooring."""
    if in_w / in_h > out_w / out_h:
        new_w = in_h * (out_w / out_h)
        left, top, right, bottom = (in_w - new_w) / 2, 0.0, (in_w + new_w) / 2, float(in_h)
    else:
        new_h = in_w * (out_h / out_w)
        left, top, right, bottom = 0.0, (in_h - new_h) / 2, float(in_w), (in_h + new_h) / 2
    left, top, right, bottom = int(left), int(top), int(right), int(bottom)
    return top, left, bottom - top, right - left


def crop_resize(camera_u8, out_h: int, out_w: int):
    """[H, W, 3] uint8 camera frame -> [out_h, out_w, 3] float32 in [0, 1]."""
    top, left, h, w = center_crop_box(camera_u8.shape[0], camera_u8.shape[1], out_h, out_w)
    f = camera_u8.float()
    rows = _resample(f, top, h, out_h)
    out = _resample(rows.transpose(0, 1), left, w, out_w).transpose(0, 1)
    return torch.clamp(_div(out, 255.0), 0.0, 1.0)


def control_image(img01, low: float, high: float):
    """Sobel edges of PIL's flooring luma, normalized by the image's maximum,
    then the double threshold (>= high -> 1, <= low -> 0): [H, W, 3]."""
    r, g, b = img01[..., 0], img01[..., 1], img01[..., 2]
    gray = _div(torch.floor(_div((299.0 * r + 587.0 * g + 114.0 * b) * 255.0, 1000.0)), 255.0)
    p = torch.nn.functional.pad(gray, (1, 1, 1, 1))
    h, w = gray.shape

    def sh(dy, dx):
        return p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    gx = (sh(-1, 1) + 2.0 * sh(0, 1) + sh(1, 1)) - (sh(-1, -1) + 2.0 * sh(0, -1) + sh(1, -1))
    gy = (sh(1, -1) + 2.0 * sh(1, 0) + sh(1, 1)) - (sh(-1, -1) + 2.0 * sh(-1, 0) + sh(-1, 1))
    mag = torch.sqrt((gx * gx + gy * gy).double()).float()
    edge = mag / torch.clamp(mag.max(), min=1e-12)
    edge = torch.where(edge >= high, 1.0, edge)
    edge = torch.where(edge <= low, 0.0, edge)
    return edge[..., None].expand(h, w, 3)


# ------------------------------------------------------------------ LCM


def alphas_cumprod(device, n: int = 1000, beta_start: float = 0.00085, beta_end: float = 0.012):
    """The scaled-linear schedule's cumulative alphas, float32."""
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, n, dtype=np.float64) ** 2
    return torch.from_numpy(np.cumprod(1.0 - betas).astype(np.float32)).to(device)


def lcm_timesteps(strength: float, steps: int, origin_steps: int = 50, n_train: int = 1000):
    """The strength-aware LCM ladder: the real timesteps, largest first."""
    n = int(math.floor(np.float32(strength) * np.float32(origin_steps)))
    skip = max(n // steps, 1)
    k = min((n + skip - 1) // skip, steps)
    c = n_train // origin_steps
    return [min(max((max(n - 1 - i * skip, 0) + 1) * c - 1, 0), n_train - 1) for i in range(k)]


def seeded_noise(seed: int, rows: int, h: int, w: int, device):
    """[rows, h, w, 4] standard normals from a generator seeded with the
    stream's seed on the serving device: row 0 noises the first step, row
    s+1 re-noises after step s."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn((rows, h, w, 4), generator=g, device=device)


# ------------------------------------------------------------------ the frame


class Reference:
    """The reference of one configuration: its float32 models and the frame."""

    def __init__(self, cfg: dict, state_dicts: dict | None, device):
        """``state_dicts`` None: shapes only (on the meta device, for counting)."""
        self.cfg, self.device = cfg, torch.device(device)
        self.unet_cfg = M.config_from(M.UNetConfig, cfg["unet"])
        self.models = build_models(cfg, device="meta")
        for name, mod in self.models.items():
            if state_dicts is not None:
                mod.to_empty(device=self.device)
                mod.load_state_dict({k: v.float() for k, v in state_dicts[name].items()},
                                    strict=True)
            mod.eval().requires_grad_(False)
        self.acp = alphas_cumprod(self.device)

    @torch.no_grad()
    def encode_prompt(self, prompt: str):
        """(context [1, 77, D], pooled [1, P] or None)."""
        towers = [n for n in ("clip", "clip2") if n in self.models]
        vocab = self.models["clip"].cfg.vocab_size
        ids = tokenize(prompt, vocab, self.cfg.get("pad_to_eos", True)).to(self.device)
        outs = [self.models[n](ids) for n in towers]
        context = torch.cat([c for c, _ in outs], dim=-1)
        return context, (outs[-1][1] if len(towers) > 1 else None)

    @torch.no_grad()
    def frame(self, camera_u8, prompt: str, options: dict):
        """-> (image [H, W, 3] float32 in [0, 255] before rounding, denoised
        latents [h, w, 4]) of one camera frame under a stream's options."""
        with no_tf32():
            context, pooled = self.encode_prompt(prompt)
            return self.denoise(camera_u8.to(self.device), context, pooled, options)

    def denoise(self, camera_u8, context, pooled, opt):
        """The frame after the prompt's encoding (what a frame costs)."""
        dev, cfg, ucfg = self.device, self.cfg, self.unet_cfg
        H, W, steps = int(opt["height"]), int(opt["width"]), int(opt["steps"])
        use_cn = bool(opt.get("controlnet", True)) and "controlnet" in self.models
        img01 = crop_resize(camera_u8, H, W)
        taesd = self.models["taesd"]
        z0 = taesd.encode(img01.permute(2, 0, 1)[None]).permute(0, 2, 3, 1)  # [1, h, w, 4]
        h, w = z0.shape[1:3]
        ctrl = None
        if use_cn:
            ctrl = control_image(img01, cfg["canny_low"], cfg["canny_high"]).permute(2, 0, 1)[None]
        kw = {}
        if ucfg.addition_embed_type == "text_time":
            kw = {"text_embeds": pooled,
                  "time_ids": torch.tensor([[H, W, 0, 0, H, W]], dtype=torch.float32, device=dev)}
        w_emb = None
        if ucfg.time_cond_proj_dim is not None:
            w_emb = M.guidance_embedding(torch.tensor([float(opt["guidance_scale"])], device=dev),
                                         ucfg.time_cond_proj_dim)
        noise = (torch.empty((steps + 1, h, w, 4), device=dev) if dev.type == "meta"
                 else seeded_noise(opt["seed"], steps + 1, h, w, dev))
        ts = lcm_timesteps(float(opt["strength"]), steps)
        first = steps - len(ts)  # ladder slots before `first` are padding
        acp = self.acp
        x = (torch.sqrt(acp[ts[0]]) * z0 + torch.sqrt(1.0 - acp[ts[0]]) * noise[0])
        denoised = z0
        scale = torch.tensor([float(opt["controlnet_scale"])], device=dev)
        for i, t in enumerate(ts):
            s = first + i
            t_prev = ts[i + 1] if i + 1 < len(ts) else t
            tt = torch.tensor([t], device=dev)
            xn = x.permute(0, 3, 1, 2)
            down = mid = None
            if use_cn:
                down, mid = self.models["controlnet"](xn, tt, context, ctrl, scale, w_emb, **kw)
            eps = self.models["unet"](xn, tt, context, w_emb, down, mid, **kw).permute(0, 2, 3, 1)
            a_t = acp[t]
            pred_x0 = (x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
            ts10 = float(t) * 10.0
            c_skip = 0.25 / (ts10 ** 2 + 0.25)
            c_out = ts10 / math.sqrt(ts10 ** 2 + 0.25)
            denoised = c_out * pred_x0 + c_skip * x
            if steps > 1:
                a_prev = acp[t_prev]
                x = torch.sqrt(a_prev) * denoised + torch.sqrt(1.0 - a_prev) * noise[s + 1]
            else:
                x = denoised
        img = taesd.decode(denoised.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)[0]
        return torch.clamp(img * 255.0, 0.0, 255.0), denoised[0]


def build_models(cfg: dict, device="meta") -> dict:
    """The configuration's models, empty, on ``device``: ``{"unet", "taesd",
    "clip"}`` with ``"controlnet"`` and ``"clip2"`` where it has them."""
    ucfg = M.config_from(M.UNetConfig, cfg["unet"])
    with torch.device(device):
        models = {"unet": M.UNet2DConditionModel(ucfg)}
        if cfg.get("controlnet"):
            models["controlnet"] = M.ControlNetModel(ucfg)
        models["taesd"] = M.AutoencoderTiny(M.config_from(M.TAESDConfig, cfg["taesd"]))
        models["clip"] = M.CLIPTextModel(M.config_from(M.CLIPConfig, cfg["text_encoder"]))
        if cfg.get("text_encoder_2"):
            models["clip2"] = M.CLIPTextModel(M.config_from(M.CLIPConfig, cfg["text_encoder_2"]))
    return models
