// Native JPEG codec for the serving hot path.
//
// The per-frame JPEG decode/encode is the server's dominant host cost at
// multi-stream load (measured ~40 ms/frame of Python/PIL work in PERF.md
// "Full-stack serving"); the reference pays an equivalent price inside
// aiortc's VP8/H264 encoder instead (SURVEY.md §2.4 "native components").
// This links the system libjpeg directly and is called via ctypes, which
// releases the GIL — N streams decode/encode truly in parallel.
//
// C ABI:
//   jc_decode_rgb(data, len, out, out_cap, &h, &w)  -> 0 ok / <0 error
//     out receives packed RGB24 rows (h*w*3 bytes, h/w written back).
//   jc_encode_rgb(rgb, h, w, quality, out, out_cap, &out_len) -> 0 ok
//   jc_encode_i420(i420, h, w, quality, out, out_cap, &out_len) -> 0 ok
//     i420 is the packed planar buffer the TPU emits (ops.rgb_to_i420):
//     h*w Y bytes, then (h/2)*(w/2) U, then V.  Skips libjpeg's RGB->
//     YCbCr conversion AND its chroma downsampling pass entirely
//     (jpeg_write_raw_data) — the device already did both.
//   jc_decode_i420(data, len, out, out_cap, &h, &w) -> 0 ok / <0 error
//     The camera-input counterpart: decodes a 4:2:0 JPEG straight into
//     the packed planar layout (jpeg_read_raw_data) — no YCbCr->RGB
//     conversion, no chroma upsample on host; the TPU unpacks inside the
//     frame program (ops.i420_to_rgb255) and the upload is 1.5 B/pixel.
//     Requires a 2x2/1x1/1x1-sampled JPEG with /16 dimensions (what
//     browsers and PIL emit at the client's /16-negotiated sizes);
//     returns -5 otherwise so the caller falls back to the RGB path.
//
// All entry points are one-shot (no persistent state) and thread-safe.

#include <csetjmp>
#include <cstdint>
#include <cstdio>   // jpeglib.h needs FILE
#include <cstdlib>
#include <cstring>

#include <jpeglib.h>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void on_error(j_common_ptr cinfo) {
  ErrMgr* err = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(err->jb, 1);
}

void on_message(j_common_ptr) {}  // keep libjpeg warnings off stderr

}  // namespace

extern "C" {

int jc_decode_rgb(const uint8_t* data, size_t len, uint8_t* out,
                  size_t out_cap, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = on_error;
  jerr.pub.output_message = on_message;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;  // corrupt stream
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const size_t stride = size_t(cinfo.output_width) * 3;
  if (stride * cinfo.output_height > out_cap) {
    jpeg_destroy_decompress(&cinfo);
    return -3;  // caller buffer too small
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + size_t(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  *h = int(cinfo.output_height);
  *w = int(cinfo.output_width);
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int jc_decode_i420(const uint8_t* data, size_t len, uint8_t* out,
                   size_t out_cap, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = on_error;
  jerr.pub.output_message = on_message;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;  // corrupt stream
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  const int H = int(cinfo.image_height), W = int(cinfo.image_width);
  // raw read hands back whole iMCU rows (16 luma rows) at block-padded
  // widths; /16 dims keep those exactly equal to our tightly-packed
  // planes, so rows can point straight into the output buffer
  if (cinfo.num_components != 3 || H % 16 || W % 16 ||
      cinfo.comp_info[0].h_samp_factor != 2 ||
      cinfo.comp_info[0].v_samp_factor != 2 ||
      cinfo.comp_info[1].h_samp_factor != 1 ||
      cinfo.comp_info[1].v_samp_factor != 1 ||
      cinfo.comp_info[2].h_samp_factor != 1 ||
      cinfo.comp_info[2].v_samp_factor != 1) {
    jpeg_destroy_decompress(&cinfo);
    return -5;  // not plain 4:2:0 — caller falls back to RGB decode
  }
  if (size_t(H) * W * 3 / 2 > out_cap) {
    jpeg_destroy_decompress(&cinfo);
    return -3;
  }
  cinfo.raw_data_out = TRUE;
  cinfo.do_fancy_upsampling = FALSE;  // no upsampling happens anyway
  jpeg_start_decompress(&cinfo);
  uint8_t* Y = out;
  uint8_t* U = out + size_t(H) * W;
  uint8_t* V = U + size_t(H / 2) * (W / 2);
  JSAMPROW yrows[16], urows[8], vrows[8];
  JSAMPARRAY planes[3] = {yrows, urows, vrows};
  while (cinfo.output_scanline < cinfo.output_height) {
    const int base = int(cinfo.output_scanline);
    for (int i = 0; i < 16; ++i)
      yrows[i] = Y + size_t(base + i) * W;
    for (int i = 0; i < 8; ++i) {
      urows[i] = U + size_t(base / 2 + i) * (W / 2);
      vrows[i] = V + size_t(base / 2 + i) * (W / 2);
    }
    if (jpeg_read_raw_data(&cinfo, planes, 16) == 0) {
      jpeg_destroy_decompress(&cinfo);
      return -6;  // suspension (should not happen with mem source)
    }
  }
  *h = H;
  *w = W;
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int jc_encode_rgb(const uint8_t* rgb, int h, int w, int quality, uint8_t* out,
                  size_t out_cap, size_t* out_len) {
  jpeg_compress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = on_error;
  jerr.pub.output_message = on_message;
  // volatile: modified between setjmp and longjmp — non-volatile locals
  // would be indeterminate on the error path (free of a stale pointer)
  unsigned char* volatile buf = nullptr;
  volatile unsigned long buf_len = 0;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_compress(&cinfo);
    if (buf) free(buf);
    return -1;
  }
  jpeg_create_compress(&cinfo);
  // libjpeg manages an internal growable buffer; copied out below (the
  // extra memcpy is ~100 us at 512x512 q85, negligible vs entropy coding)
  jpeg_mem_dest(&cinfo, const_cast<unsigned char**>(&buf),
                const_cast<unsigned long*>(&buf_len));
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  const size_t stride = size_t(w) * 3;
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<uint8_t*>(rgb) + size_t(cinfo.next_scanline) * stride;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  unsigned char* done_buf = buf;
  unsigned long done_len = buf_len;
  if (done_len > out_cap) {
    free(done_buf);
    return -3;
  }
  memcpy(out, done_buf, done_len);
  *out_len = done_len;
  free(done_buf);
  return 0;
}

int jc_encode_i420(const uint8_t* i420, int h, int w, int quality,
                   uint8_t* out, size_t out_cap, size_t* out_len) {
  // w%16==0 keeps chroma rows block-aligned (w/2 % 8 == 0), so no
  // horizontal MCU padding is needed; serving sizes are /16-negotiated
  // (client app.js) so this always holds on the hot path.  h is padded
  // vertically by last-row replication below.
  if (h % 2 || w % 16) return -4;
  jpeg_compress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = on_error;
  jerr.pub.output_message = on_message;
  unsigned char* volatile buf = nullptr;
  volatile unsigned long buf_len = 0;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_compress(&cinfo);
    if (buf) free(buf);
    return -1;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, const_cast<unsigned char**>(&buf),
                const_cast<unsigned long*>(&buf_len));
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_YCbCr;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  cinfo.raw_data_in = TRUE;
  cinfo.comp_info[0].h_samp_factor = 2;  // 4:2:0, matching the device pack
  cinfo.comp_info[0].v_samp_factor = 2;
  cinfo.comp_info[1].h_samp_factor = 1;
  cinfo.comp_info[1].v_samp_factor = 1;
  cinfo.comp_info[2].h_samp_factor = 1;
  cinfo.comp_info[2].v_samp_factor = 1;
  jpeg_start_compress(&cinfo, TRUE);
  const uint8_t* Y = i420;
  const uint8_t* U = i420 + size_t(h) * w;
  const uint8_t* V = U + size_t(h / 2) * (w / 2);
  JSAMPROW yrows[16], urows[8], vrows[8];
  JSAMPARRAY planes[3] = {yrows, urows, vrows};
  while (cinfo.next_scanline < cinfo.image_height) {
    const int base = int(cinfo.next_scanline);
    for (int i = 0; i < 16; ++i) {
      int r = base + i;
      if (r >= h) r = h - 1;  // replicate last row into MCU padding
      yrows[i] = const_cast<uint8_t*>(Y + size_t(r) * w);
    }
    for (int i = 0; i < 8; ++i) {
      int r = base / 2 + i;
      if (r >= h / 2) r = h / 2 - 1;
      urows[i] = const_cast<uint8_t*>(U + size_t(r) * (w / 2));
      vrows[i] = const_cast<uint8_t*>(V + size_t(r) * (w / 2));
    }
    jpeg_write_raw_data(&cinfo, planes, 16);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  unsigned char* done_buf = buf;
  unsigned long done_len = buf_len;
  if (done_len > out_cap) {
    free(done_buf);
    return -3;
  }
  memcpy(out, done_buf, done_len);
  *out_len = done_len;
  free(done_buf);
  return 0;
}

}  // extern "C"
