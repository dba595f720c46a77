// Threaded PNG/JPEG decode for the host input pipeline of xview2_tpu_torch
// (the port's copy of the JAX package's native/decoder.cpp, the same code).
//
// The reference's input pipeline leaned on OpenCV's native decoders inside 8
// worker *processes* per rank (reference data_loading/pytorch_loader.py).
// Here a single shared library provides a GIL-free batch decoder driven by a
// pthread pool: Python hands in file paths and one preallocated uint8 output
// block; C++ reads, decodes (libpng/libjpeg), and writes each image into its
// batch slot.  Used by xview2_tpu_torch/data/native.py via ctypes, which
// builds it at first use and falls back to PIL when it cannot.
//
// Build (data/native.py does it): g++ -O3 -shared -fPIC decoder.cpp -lpng -ljpeg -lpthread

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <png.h>
#include <pthread.h>
#include <setjmp.h>
#include <stdio.h>
#include <vector>

extern "C" {
#include <jpeglib.h>
}

namespace {

// ---------------------------------------------------------------------------
// PNG decode into caller-provided HxWxC uint8 buffer.
// Handles 8/16-bit gray, palette, RGB, RGBA sources; converts to the
// requested channel count (1 or 3).  Returns 0 on success.
// ---------------------------------------------------------------------------
int decode_png_file(const char* path, uint8_t* out, int out_h, int out_w,
                    int out_c) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return -1;

  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    fclose(fp);
    return -2;
  }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    fclose(fp);
    return -2;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return -3;
  }
  png_init_io(png, fp);
  png_read_info(png, info);

  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);

  if ((int)w != out_w || (int)h != out_h) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return -4;  // size mismatch: caller allocated the wrong shape
  }

  // normalize source to 8-bit; expand palette / low-bit gray
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);

  if (out_c == 3) {
    if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
      png_set_gray_to_rgb(png);
    png_set_strip_alpha(png);
  } else {  // out_c == 1: label masks; keep first channel
    if (color == PNG_COLOR_TYPE_RGB || color == PNG_COLOR_TYPE_RGB_ALPHA ||
        color == PNG_COLOR_TYPE_PALETTE)
      png_set_rgb_to_gray_fixed(png, 1 /*error_action silent*/, -1, -1);
    png_set_strip_alpha(png);
  }
  png_read_update_info(png, info);

  size_t rowbytes = png_get_rowbytes(png, info);
  if (rowbytes != (size_t)out_w * out_c) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return -5;
  }
  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; ++y)
    rows[y] = out + (size_t)y * out_w * out_c;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(fp);
  return 0;
}

// ---------------------------------------------------------------------------
// JPEG decode (xBD ships PNG, but the loader accepts either).
// ---------------------------------------------------------------------------
int decode_jpeg_file(const char* path, uint8_t* out, int out_h, int out_w,
                     int out_c) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return -1;
  jpeg_decompress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    fclose(fp);
    return -2;
  }
  cinfo.out_color_space = (out_c == 1) ? JCS_GRAYSCALE : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if ((int)cinfo.output_width != out_w || (int)cinfo.output_height != out_h ||
      (int)cinfo.output_components != out_c) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    fclose(fp);
    return -4;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + (size_t)cinfo.output_scanline * out_w * out_c;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(fp);
  return 0;
}

bool has_suffix(const char* s, const char* suf) {
  size_t ls = strlen(s), lf = strlen(suf);
  return ls >= lf && strcasecmp(s + ls - lf, suf) == 0;
}

int decode_any(const char* path, uint8_t* out, int h, int w, int c) {
  if (has_suffix(path, ".jpg") || has_suffix(path, ".jpeg"))
    return decode_jpeg_file(path, out, h, w, c);
  return decode_png_file(path, out, h, w, c);
}

// ---------------------------------------------------------------------------
// pthread pool for batch decode
// ---------------------------------------------------------------------------
struct BatchJob {
  const char** paths;
  uint8_t* out;       // (n, h, w, c) contiguous
  int n, h, w, c;
  int* results;       // per-item status
  int next;           // work index (guarded by mutex)
  pthread_mutex_t mu;
};

void* worker(void* arg) {
  BatchJob* job = (BatchJob*)arg;
  for (;;) {
    pthread_mutex_lock(&job->mu);
    int i = job->next++;
    pthread_mutex_unlock(&job->mu);
    if (i >= job->n) return nullptr;
    size_t stride = (size_t)job->h * job->w * job->c;
    job->results[i] = decode_any(job->paths[i], job->out + stride * i, job->h,
                                 job->w, job->c);
  }
}

}  // namespace

extern "C" {

int xv2_decode_image(const char* path, uint8_t* out, int h, int w, int c) {
  return decode_any(path, out, h, w, c);
}

// Decodes n images concurrently into out (n,h,w,c).  Returns 0 if all items
// succeeded, else the first nonzero item status.
int xv2_decode_batch(const char** paths, uint8_t* out, int n, int h, int w,
                     int c, int n_threads, int* results) {
  BatchJob job{paths, out, n, h, w, c, results, 0, PTHREAD_MUTEX_INITIALIZER};
  if (n_threads > n) n_threads = n;
  if (n_threads < 1) n_threads = 1;
  std::vector<pthread_t> threads(n_threads);
  for (int t = 0; t < n_threads; ++t)
    pthread_create(&threads[t], nullptr, worker, &job);
  for (int t = 0; t < n_threads; ++t) pthread_join(threads[t], nullptr);
  int status = 0;
  for (int i = 0; i < n; ++i)
    if (results[i] != 0) {
      status = results[i];
      break;
    }
  return status;
}

// Probe image dimensions without full decode.  Returns 0 and fills h/w.
int xv2_probe_png(const char* path, int* h, int* w) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return -1;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (!png || !info || setjmp(png_jmpbuf(png))) {
    if (png) png_destroy_read_struct(&png, info ? &info : nullptr, nullptr);
    fclose(fp);
    return -2;
  }
  png_init_io(png, fp);
  png_read_info(png, info);
  *w = (int)png_get_image_width(png, info);
  *h = (int)png_get_image_height(png, info);
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(fp);
  return 0;
}

}  // extern "C"
