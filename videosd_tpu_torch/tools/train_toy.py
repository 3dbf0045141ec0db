"""Train toy weights with the port, so quality metrics become meaningful.

Counterpart of ``videosd_tpu/tools/train_toy.py``: the same three stages,
flags and JSON report (plus ``device``), on the port's training stack.  A
random UNet does not contract toward any image manifold, so the quality
tools (the turbo ladder's PSNR, warm-start damping) need a denoiser that
was trained; no checkpoint can be downloaded, so this tool trains a small
one on the synthetic structured-frame distribution those tools drive:

* **Stage A -- TAESD autoencoder**: reconstruction MSE over augmented
  structured frames (encoder and decoder jointly; a small latent L2 keeps
  codes inside the decoder's tanh clamp), with ``adam``.
* **Stage B -- UNet eps-prediction** in the trained latent space, through
  ``train/step.py::make_train_step``, conditioned on the bundle's CLIP
  embeddings of the tools' fixed prompt and, when the config has LCM
  guidance conditioning, the w-embedding at guidance 5.0.
* **Stage C -- ControlNet** against the frozen Stage-B UNet
  (``make_controlnet_train_step``), conditioned on the canny maps the
  frame program computes (``ops/sobel.py::sobel_control_image``), with the
  paired holdout eval (``make_controlnet_eval``): without this stage the
  ControlNet's zero-initialized output convs make it a no-op.

The result is written by ``io/checkpoint.py::save_bundle``; the port's
``ModelBundle.from_dir`` and the JAX package's loader both read it, and
``tools/turbo_ladder.py --weights`` drives it.  Timesteps and noise come
from a ``torch.Generator`` seeded from ``--seed`` on the device (not JAX's
threefry draws).  The stages run on ``--device`` (default ``cuda``; there is
no fallback to the CPU).

Usage:
    python -m videosd_tpu_torch.tools.train_toy --out DIR
        [--family tiny] [--size 64] [--ae-steps 1500] [--unet-steps 3000]
        [--batch 16] [--lr 2e-4] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


_BASE_CACHE: dict = {}


def make_batch(rng: np.random.Generator, n: int, h: int, w: int) -> np.ndarray:
    """Augmented structured frames: the drifting-camera family the flicker
    metric replays (tools/flicker.py drifting_frame), widened with random
    base frames, shifts on both axes, and brightness scaling.  Base frames
    are cached (structured_frame dominates generation cost; rolls are
    cheap), so the training loop stays device-bound."""
    from videosd_tpu_torch.tools.turbo_ladder import structured_frame

    out = np.empty((n, h, w, 3), np.float32)
    for i in range(n):
        idx = int(rng.integers(0, 32))
        base = _BASE_CACHE.get((idx, h, w))
        if base is None:
            base = structured_frame(idx, h, w).astype(np.float32)
            _BASE_CACHE[(idx, h, w)] = base
        base = np.roll(base, int(rng.integers(0, w)), axis=1)
        base = np.roll(base, int(rng.integers(0, h)), axis=0)
        out[i] = np.clip(base * rng.uniform(0.94, 1.06), 0, 255)
    return out / 127.5 - 1.0  # [-1,1], the pipeline's image domain


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--family", default="tiny")
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--ae-steps", type=int, default=1500)
    ap.add_argument("--unet-steps", type=int, default=3000)
    ap.add_argument("--cn-steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--cn-lr", type=float, default=None,
                    help="Stage-C learning rate (default: --lr); the ControlNet's zero-init "
                    "output convs gate its gradient scale, so it tolerates a higher rate")
    ap.add_argument("--cn-strength-match", type=float, default=1.0,
                    help="draw Stage-C timesteps below frac*T: serving evaluates the "
                    "ControlNet only on the img2img ladder (t < strength*T)")
    ap.add_argument("--optimizer", default="adamw", choices=("adamw", "adafactor"),
                    help="UNet/ControlNet stages; adafactor keeps a factored second "
                    "moment instead of Adam's two full ones")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default="cuda",
                    help="where the stages run (cpu for a short run without a card)")
    args = ap.parse_args(argv)
    if args.ae_steps < 1 or args.unet_steps < 1 or args.cn_steps < 0:
        ap.error("--ae-steps and --unet-steps must be >= 1 and --cn-steps "
                 ">= 0 (the report's final-loss fields come from the last "
                 "executed step; --cn-steps 0 skips Stage C)")

    import torch

    from videosd_tpu_torch.io.checkpoint import save_bundle
    from videosd_tpu_torch.models.layers import guidance_embedding
    from videosd_tpu_torch.models.taesd import taesd_decode, taesd_encode
    from videosd_tpu_torch.pipelines.lcm_img2img import ModelBundle, build_prompt_encoder
    from videosd_tpu_torch.train.optim import adafactor, adam, adamw
    from videosd_tpu_torch.train.step import init_train_state, make_train_step

    device = torch.device(args.device)
    bundle = ModelBundle.random(args.family, dtype=torch.float32, device=device)
    tcfg = bundle.taesd_cfg
    rng = np.random.default_rng(args.seed)
    h = w = args.size
    report: dict = {"family": args.family, "size": args.size,
                    "device": torch.cuda.get_device_name(device)
                    if device.type == "cuda" else str(device)}

    def frames(r, n):
        return torch.from_numpy(make_batch(r, n, h, w)).to(device)

    # ---- Stage A: TAESD reconstruction --------------------------------
    taesd = bundle.models["taesd"]
    ae = init_train_state(taesd, adam(args.lr))

    def ae_step(imgs):
        ae["optimizer"].zero_grad(set_to_none=True)
        z = taesd_encode(taesd, imgs, tcfg)
        rec = taesd_decode(taesd, z, tcfg)
        mse = torch.mean((rec - imgs) ** 2)
        # keep codes inside the decoder's tanh(z/3)*3 soft clamp
        reg = torch.mean(torch.clamp(torch.abs(z) - 2.5, min=0.0) ** 2)
        (mse + 0.05 * reg).backward()
        ae["optimizer"].step()
        return mse.detach()

    t0 = time.perf_counter()
    for step in range(args.ae_steps):
        mse = ae_step(frames(rng, args.batch))
        if step == 0:
            report["ae_first_mse"] = float(mse)
        if step % 200 == 0 or step == args.ae_steps - 1:
            print(f"# ae step {step}: recon mse {float(mse):.5f}", flush=True)
    report["ae_final_mse"] = float(mse)
    report["ae_seconds"] = round(time.perf_counter() - t0, 1)
    taesd.requires_grad_(False)

    def encode(imgs):
        with torch.no_grad():
            return taesd_encode(taesd, imgs, tcfg)

    # PSNR of the reconstruction on a held-out frame (u8 domain)
    test = frames(np.random.default_rng(9999), 4)
    with torch.no_grad():
        rec = taesd_decode(taesd, encode(test), tcfg)
    err = torch.mean((torch.clamp(rec, -1, 1) - test) ** 2) * (127.5**2)
    report["ae_holdout_psnr_db"] = round(float(10 * torch.log10(255.0**2 / err)), 2)
    print(f"# ae holdout PSNR {report['ae_holdout_psnr_db']} dB", flush=True)

    # ---- Stage B: UNet denoiser in the trained latent space -----------
    embeds, _ = build_prompt_encoder(bundle)(bundle.tokenizer(["portrait, pixar, cg"]))
    context = embeds.float().repeat(args.batch, 1, 1)  # the tools' fixed prompt
    w_cond = None
    if bundle.unet_cfg.time_cond_proj_dim is not None:
        w_cond = guidance_embedding(torch.full((args.batch,), 5.0, device=device),
                                    bundle.unet_cfg.time_cond_proj_dim)

    def make_opt(lr):
        return adafactor(lr) if args.optimizer == "adafactor" else adamw(lr)

    state = init_train_state(bundle.models["unet"], make_opt(args.lr))
    step_fn = make_train_step(bundle.sched_cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    t0 = time.perf_counter()
    for step in range(args.unet_steps):
        batch = {"latents": encode(frames(rng, args.batch)), "context": context}
        if w_cond is not None:
            batch["w_cond"] = w_cond
        metrics = step_fn(state, batch, generator=gen)
        if step % 200 == 0 or step == args.unet_steps - 1:
            print(f"# unet step {step}: loss {float(metrics['loss']):.5f}", flush=True)
    report["unet_final_loss"] = float(metrics["loss"])
    report["unet_seconds"] = round(time.perf_counter() - t0, 1)
    unet = bundle.models["unet"].requires_grad_(False)

    # ---- Stage C: ControlNet against the frozen UNet ------------------
    if args.cn_steps > 0:
        from videosd_tpu_torch.ops.sobel import sobel_control_image
        from videosd_tpu_torch.train.step import make_controlnet_eval, make_controlnet_train_step

        def canny(imgs):
            # serving feeds canny of the [0,1] camera frame (FrameSpec's
            # canny_low/high defaults)
            return sobel_control_image((imgs + 1.0) * 0.5, 0.11, 0.8)

        cn_lr = args.cn_lr if args.cn_lr is not None else args.lr
        t_hi = max(1, int(bundle.sched_cfg.num_train_timesteps
                          * min(1.0, max(0.0, args.cn_strength_match))))
        cn_state = init_train_state(bundle.models["controlnet"], make_opt(cn_lr))
        cn_step = make_controlnet_train_step(bundle.sched_cfg, t_max=t_hi)

        # paired holdout (fixed frames, fixed serving-range timesteps, fixed
        # noise): base vs +CN eps-MSE, the convergence check that training-loss
        # wiggle cannot provide
        cn_eval = make_controlnet_eval(bundle.sched_cfg)
        ev_imgs = frames(np.random.default_rng(7777), 4)
        ev_batch = {"latents": encode(ev_imgs), "context": embeds.float().repeat(4, 1, 1),
                    "control": canny(ev_imgs)}
        if w_cond is not None:
            ev_batch["w_cond"] = w_cond[:1].repeat(4, 1)
        ev_t = torch.from_numpy(np.linspace(t_hi * 0.15, t_hi - 1, 4).astype(np.int32))
        ev_noise = torch.randn(ev_batch["latents"].shape, device=device,
                               generator=torch.Generator(device=device).manual_seed(31337))

        def holdout():
            base, cn = cn_eval(bundle.models["controlnet"], unet, ev_batch, ev_t,
                               noise=ev_noise)
            return float(base), float(cn)

        t0 = time.perf_counter()
        for step in range(args.cn_steps):
            imgs = frames(rng, args.batch)
            batch = {"latents": encode(imgs), "context": context, "control": canny(imgs)}
            if w_cond is not None:
                batch["w_cond"] = w_cond
            metrics = cn_step(cn_state, unet, batch, generator=gen)
            if step == 0:
                report["cn_first_loss"] = float(metrics["loss"])
            if step % 200 == 0 or step == args.cn_steps - 1:
                base, cn = holdout()
                print(
                    f"# controlnet step {step}: loss {float(metrics['loss']):.5f}"
                    f"  holdout base {base:.5f} vs +cn {cn:.5f}"
                    f"  (gain {100.0 * (1.0 - cn / base):.1f}%)",
                    flush=True,
                )
        report["cn_final_loss"] = float(metrics["loss"])
        base, cn = holdout()
        report["cn_holdout_base_loss"] = round(base, 6)
        report["cn_holdout_cn_loss"] = round(cn, 6)
        report["cn_holdout_gain_pct"] = round(100.0 * (1.0 - cn / base), 2)
        report["cn_t_max"] = t_hi
        report["cn_lr"] = cn_lr
        report["cn_seconds"] = round(time.perf_counter() - t0, 1)
        bundle.models["controlnet"].requires_grad_(False)

    save_bundle(bundle, args.out)
    report["out"] = args.out
    print(json.dumps(report))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
