"""Engine mixin: frame geometry + wire-format codecs.

The port's counterpart of ``videosd_tpu/runtime/engine_framing.py``:
mailbox layout (RGB / packed I420), camera-frame fitting with true-extent
tracking (the on-device center crop must see the REAL camera geometry),
resolution snapping, and output packing (on the device, through the
port's ``ops/preprocess.rgb_to_i420``).
"""

from __future__ import annotations

import numpy as np

__all__ = ["FrameIOMixin"]


class FrameIOMixin:
    def _mailbox_shape(self) -> tuple[int, ...]:
        h, w = self.frame_hw
        if self.input_format == "i420":
            return (h * 3 // 2, w)
        return (h, w, 3)

    def _mailbox_nbytes(self) -> int:
        return int(np.prod(self._mailbox_shape()))

    def set_input_format(self, fmt: str):
        """Flip the camera-upload layout live (ops A/B via /debug/engine).

        Mailbox slots are allocated at RGB size so both layouts fit; the
        drain discards frames stored in the OLD layout (one dropped frame
        per active stream at most — streams resubmit immediately).  The
        first bucket in the new layout is a fresh program spec: the
        cold-bucket path serves passthrough frames while it warms up in
        the background, exactly like any cold bucket."""
        fmt = str(fmt).lower()
        if fmt not in ("rgb", "i420"):
            raise ValueError(f"input_format must be rgb|i420, got {fmt!r}")
        if fmt == "i420" and (self.frame_hw[0] % 4 or self.frame_hw[1] % 2):
            raise ValueError(
                f"input_format=i420 needs frame_hw H%4==0 W%2==0, "
                f"got {self.frame_hw}"
            )
        if fmt == self.input_format:
            return
        self.input_format = fmt
        buf = np.empty(self._mailbox_shape(), np.uint8)
        for sid, st in self.streams.items():
            if self.queue.has_fresh(sid):
                self.queue.take(sid, buf)
            st.last_input = None  # old-layout frame: similarity reset

    def _fit_frame(self, frame: np.ndarray) -> tuple[np.ndarray, tuple[int, int]]:
        """Mailboxes are fixed-size; place the camera frame top-left and
        return (mailbox_frame, true_extent).  The true extent rides to the
        device as a traced source box, so the on-device center-crop sees
        the REAL camera geometry (reference crops at full camera
        resolution, videopipeline.py:91-107).  Frames LARGER than the
        mailbox (out-of-contract: the client negotiates <= 768) are
        host-center-cropped — centered, never top-left.

        An i420-input engine fits per PLANE (Y top-left in the Y region,
        U/V in their subplane grids); RGB frames submitted to it are
        host-packed first, so callers may submit either layout."""
        if self.input_format == "i420":
            if frame.ndim == 3:
                from videosd_tpu_torch.ops.preprocess import rgb_to_i420_host

                fh, fw = frame.shape[:2]
                frame = rgb_to_i420_host(
                    frame[: fh - fh % 4, : fw - fw % 2, :3]
                )
            return self._fit_frame_i420(frame)
        return self._fit_frame_rgb(frame)

    def _fit_frame_rgb(
        self, frame: np.ndarray
    ) -> tuple[np.ndarray, tuple[int, int]]:
        """RGB mailbox fit — also used for ref frames on an i420-input
        engine (style references upload as RGB regardless of the camera
        layout; they change once per set_ref, not per frame)."""
        h, w = self.frame_hw
        fh, fw = frame.shape[:2]
        if (fh, fw) == (h, w):
            return frame, (fh, fw)
        ch, cw = min(h, fh), min(w, fw)
        y0, x0 = (fh - ch) // 2, (fw - cw) // 2
        out = np.zeros((h, w, 3), np.uint8)
        out[:ch, :cw] = frame[y0 : y0 + ch, x0 : x0 + cw, :3]
        return out, (ch, cw)

    def _fit_frame_i420(
        self, packed: np.ndarray
    ) -> tuple[np.ndarray, tuple[int, int]]:
        """Packed-plane analog of :meth:`_fit_frame`: copy Y/U/V subplanes
        top-left into the mailbox's plane regions (even-aligned so the
        chroma grid stays 2x2-consistent); padding is Y=0 / chroma=128
        (black), which the traced source box keeps out of the crop."""
        h, w = self.frame_hw
        fh, fw = (packed.shape[0] * 2) // 3, packed.shape[1]
        if (fh, fw) == (h, w):
            return packed, (fh, fw)
        ch, cw = min(h, fh) & ~1, min(w, fw) & ~1
        y0, x0 = ((fh - ch) // 2) & ~1, ((fw - cw) // 2) & ~1
        out = np.full((h * 3 // 2, w), 128, np.uint8)
        out[:h] = 0
        out[:ch, :cw] = packed[y0 : y0 + ch, x0 : x0 + cw]
        src_u = packed[fh : fh + fh // 4].reshape(fh // 2, fw // 2)
        src_v = packed[fh + fh // 4 :].reshape(fh // 2, fw // 2)
        dst_u = out[h : h + h // 4].reshape(h // 2, w // 2)
        dst_v = out[h + h // 4 :].reshape(h // 2, w // 2)
        dst_u[: ch // 2, : cw // 2] = src_u[
            y0 // 2 : (y0 + ch) // 2, x0 // 2 : (x0 + cw) // 2
        ]
        dst_v[: ch // 2, : cw // 2] = src_v[
            y0 // 2 : (y0 + ch) // 2, x0 // 2 : (x0 + cw) // 2
        ]
        return out, (ch, cw)

    def _src_box(self, in_hw, out_h: int, out_w: int) -> tuple[int, int, int, int]:
        """(top, left, height, width) center-crop of the true camera
        extent matching the target aspect ratio — host-computed with the
        SAME geometry function as the static path (ops.center_crop_box),
        handed to the program as traced data."""
        from videosd_tpu_torch.ops.preprocess import center_crop_box

        ih, iw = in_hw or self.frame_hw
        left, top, right, bottom = center_crop_box(iw, ih, out_w, out_h)
        return (top, left, bottom - top, right - left)

    def _maybe_pack_i420(self, out):
        """RGB u8 [B,H,W,3] -> packed I420 [B,3H/2,W] on the device when the
        engine serves i420 and the bucket geometry packs; identity
        otherwise.  Downstream consumers branch on ndim (2 = packed), so
        non-packable buckets degrade to RGB without a mode switch."""
        if self.output_format != "i420":
            return out
        h, w = int(out.shape[1]), int(out.shape[2])
        if h % 4 or w % 2:
            return out
        from videosd_tpu_torch.ops.preprocess import rgb_to_i420

        return rgb_to_i420(out)

    def _black_output(self, h: int, w: int) -> np.ndarray:
        """Black init frame in the stream's wire format (reference
        server.py:99,122): Y=0 + neutral chroma when packing I420."""
        if self.output_format == "i420" and h % 4 == 0 and w % 2 == 0:
            buf = np.full((h * 3 // 2, w), 128, np.uint8)
            buf[:h] = 0
            return buf
        return np.zeros((h, w, 3), np.uint8)

    @staticmethod
    def _as_rgb(frame: np.ndarray) -> np.ndarray:
        """Output frame (RGB [H,W,3] or packed I420 [3H/2,W]) -> RGB.
        Host cost only where RGB is genuinely demanded (reference-frame
        feedback, raw-RGB24 WS replies)."""
        if frame.ndim == 2:
            from videosd_tpu_torch.ops.preprocess import i420_to_rgb_host

            return i420_to_rgb_host(frame)
        return frame


    def _snap_resolution(self, h: int, w: int) -> tuple[int, int]:
        """Snap a requested (h, w) to the nearest configured resolution
        bucket (by area then aspect difference).  No-op when no buckets are
        configured — each distinct resolution then builds its own
        program, exactly like the reference honors arbitrary sizes."""
        buckets = tuple(self.config.resolution_buckets or ())
        if not buckets:
            return h, w
        return min(
            (tuple(b) for b in buckets),
            key=lambda b: (abs(b[0] * b[1] - h * w), abs(b[0] - h) + abs(b[1] - w)),
        )

