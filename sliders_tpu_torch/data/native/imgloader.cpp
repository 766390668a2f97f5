// JPEG decoder of the image-slider reader (the libjpeg branch of
// sliders_tpu/data/native/imgloader.cpp, copied; the PNG branch is decoded
// in Python by ../native_loader.py, and so is the bicubic resize). Links
// against libjpeg alone.
//
// Built with g++ at the first JPEG by native_loader._jpeg_library:
//   g++ -O2 -shared -fPIC -std=c++17 imgloader.cpp -o libimgloader.so -ljpeg
//
// C ABI (ctypes):
//   jpeg_size(path, &w, &h)            -> 0 on success: the header's size
//   jpeg_decode_rgb(path, out, w, h)   -> 0 on success: out is h * w * 3
//                                         uint8, HWC RGB

#include <csetjmp>
#include <cstdint>
#include <cstdio>

#include <jpeglib.h>

namespace {

struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->jb, 1);
}

// Decodes `path` as RGB. With out == nullptr only the header is read and the
// output size stored in *w, *h; otherwise the image must be exactly w x h.
int decode(const char* path, uint8_t* out, int* w, int* h) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  int ok = 0;
  if (out == nullptr) {
    *w = int(cinfo.output_width);
    *h = int(cinfo.output_height);
    jpeg_abort_decompress(&cinfo);
  } else if (int(cinfo.output_width) != *w || int(cinfo.output_height) != *h ||
             cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    ok = 1;
  } else {
    while (cinfo.output_scanline < cinfo.output_height) {
      uint8_t* row = out + size_t(cinfo.output_scanline) * size_t(*w) * 3;
      jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
  }
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return ok;
}

}  // namespace

extern "C" {

int jpeg_size(const char* path, int* w, int* h) { return decode(path, nullptr, w, h); }

int jpeg_decode_rgb(const char* path, uint8_t* out, int w, int h) {
  return decode(path, out, &w, &h);
}

}  // extern "C"
