// Native RGB-D ingest: PNG decode + grayscale/depth conversion, and the
// host-side ingest reduction (the port's copy of
// dvo_slam_tpu/native/ingest.cpp).
//
// The reference's host-side frame loading uses OpenCV in C++
// (dvo_benchmark/src/benchmark_slam.cpp:46-93: imread, BGR->gray float,
// u16 depth; dvo_core surface_pyramid.cpp:45-105 raw-depth conversion).
// Python orchestrates; this extension does the byte work with the GIL
// released so a thread-pool prefetcher overlaps dataset IO with device
// compute.
//
// Exposes:
//   decode_gray_u8(png_bytes)  -> (bytes HxW u8, h, w)
//       RGB(A)/gray PNG -> 8-bit luma using OpenCV's BT.601 weights
//       (0.299 R + 0.587 G + 0.114 B), matching cv::cvtColor BGR2GRAY.
//   decode_depth_u16(png_bytes) -> (bytes HxW u16 native-endian, h, w)
//       16-bit grayscale PNG (TUM depth) -> u16 array.
//   reduce_ingest(u8 bytes, u16 bytes, t, h, w, levels)
//       -> (u16 intensity sums, u16 subsampled depth, ho, wo)
//
// Built on first use with g++ against libpng (see __init__.py); where the
// build fails, the callers fall back to cv2 and to the NumPy reduction.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <png.h>

#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct PngReadState {
  const unsigned char* data;
  size_t size;
  size_t offset;
};

void png_read_from_memory(png_structp png, png_bytep out, png_size_t count) {
  PngReadState* state = static_cast<PngReadState*>(png_get_io_ptr(png));
  if (state->offset + count > state->size) {
    png_error(png, "read past end of PNG buffer");
  }
  std::memcpy(out, state->data + state->offset, count);
  state->offset += count;
}

struct DecodeResult {
  std::vector<unsigned char> pixels;
  png_uint_32 width = 0;
  png_uint_32 height = 0;
  bool ok = false;
  std::string error;
};

// Decode a PNG from memory; if want_depth, produce u16 single channel
// (native endian), else 8-bit luma.
DecodeResult decode(const unsigned char* bytes, size_t size, bool want_depth) {
  DecodeResult result;
  if (size < 8 || png_sig_cmp(bytes, 0, 8) != 0) {
    result.error = "not a PNG";
    return result;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  if (!png || !info) {
    if (png) png_destroy_read_struct(&png, &info, nullptr);
    result.error = "libpng init failed";
    return result;
  }
  std::vector<png_bytep> rows;
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    result.error = "libpng decode error";
    return result;
  }

  PngReadState state{bytes, size, 0};
  png_set_read_fn(png, &state, png_read_from_memory);
  png_read_info(png, info);

  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  int bit_depth = png_get_bit_depth(png, info);
  int color_type = png_get_color_type(png, info);

  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (bit_depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);

  if (want_depth) {
    // keep 16-bit; PNG is big-endian on the wire
    if (bit_depth == 16) png_set_swap(png);
  } else {
    if (bit_depth == 16) png_set_strip_16(png);
    png_set_strip_alpha(png);
  }
  png_read_update_info(png, info);

  size_t rowbytes = png_get_rowbytes(png, info);
  std::vector<unsigned char> raw(rowbytes * h);
  rows.resize(h);
  for (png_uint_32 y = 0; y < h; ++y) rows[y] = raw.data() + y * rowbytes;
  png_read_image(png, rows.data());
  png_read_end(png, nullptr);

  int channels = static_cast<int>(png_get_channels(png, info));
  png_destroy_read_struct(&png, &info, nullptr);

  result.width = w;
  result.height = h;
  if (want_depth) {
    if (channels != 1 || rowbytes != w * 2) {
      result.error = "depth PNG is not 16-bit single channel";
      return result;
    }
    result.pixels = std::move(raw);
    result.ok = true;
    return result;
  }

  result.pixels.resize(static_cast<size_t>(w) * h);
  if (channels == 1) {
    for (png_uint_32 y = 0; y < h; ++y) {
      std::memcpy(result.pixels.data() + static_cast<size_t>(y) * w,
                  raw.data() + y * rowbytes, w);
    }
  } else if (channels == 3 || channels == 4) {
    // BT.601 luma, fixed point, matching OpenCV's RGB2GRAY coefficients
    // (R*4899 + G*9617 + B*1868 + 8192) >> 14
    for (png_uint_32 y = 0; y < h; ++y) {
      const unsigned char* src = raw.data() + y * rowbytes;
      unsigned char* dst = result.pixels.data() + static_cast<size_t>(y) * w;
      for (png_uint_32 x = 0; x < w; ++x) {
        const unsigned char* p = src + x * channels;
        uint32_t luma = 4899u * p[0] + 9617u * p[1] + 1868u * p[2] + 8192u;
        dst[x] = static_cast<unsigned char>(luma >> 14);
      }
    }
  } else {
    result.error = "unsupported channel count";
    return result;
  }
  result.ok = true;
  return result;
}

PyObject* decode_common(PyObject* args, bool want_depth) {
  Py_buffer buf;
  if (!PyArg_ParseTuple(args, "y*", &buf)) return nullptr;

  DecodeResult result;
  Py_BEGIN_ALLOW_THREADS
  result = decode(static_cast<const unsigned char*>(buf.buf),
                  static_cast<size_t>(buf.len), want_depth);
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&buf);

  if (!result.ok) {
    PyErr_SetString(PyExc_ValueError, result.error.c_str());
    return nullptr;
  }
  PyObject* bytes = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(result.pixels.data()),
      static_cast<Py_ssize_t>(result.pixels.size()));
  if (!bytes) return nullptr;
  return Py_BuildValue("(Nkk)", bytes, static_cast<unsigned long>(result.height),
                       static_cast<unsigned long>(result.width));
}

PyObject* py_decode_gray(PyObject*, PyObject* args) {
  return decode_common(args, /*want_depth=*/false);
}

PyObject* py_decode_depth(PyObject*, PyObject* args) {
  return decode_common(args, /*want_depth=*/true);
}

// ---------------------------------------------------------------------------
// Host-side ingest reduction (the C++ twin of streaming.host_reduce_ingest):
// intensity as a lossless u16 2x2-SUM per level (values scaled 4^levels),
// depth as the reference's subsample decimation (rgbd_image.cpp:127-139).
// Iterated per level with floor-halved dims, bit-identical to the NumPy
// oracle.  Frames split across two worker threads; the GIL is released for
// the whole reduction.
// ---------------------------------------------------------------------------

void reduce_frames(const uint8_t* iu8, const uint16_t* du16, size_t t0,
                   size_t t1, size_t h, size_t w, int levels, uint16_t* i_out,
                   uint16_t* d_out, size_t ho, size_t wo,
                   std::vector<uint16_t>& scratch) {
  // scratch holds one frame's intermediate intensity level (u16)
  for (size_t t = t0; t < t1; ++t) {
    const uint8_t* src8 = iu8 + t * h * w;
    size_t ch = h, cw = w;
    // level 0 -> 1 from u8
    size_t nh = ch / 2, nw = cw / 2;
    uint16_t* cur = scratch.data();
    for (size_t y = 0; y < nh; ++y) {
      const uint8_t* r0 = src8 + (2 * y) * cw;
      const uint8_t* r1 = src8 + (2 * y + 1) * cw;
      uint16_t* dst = cur + y * nw;
      for (size_t x = 0; x < nw; ++x)
        dst[x] = static_cast<uint16_t>(r0[2 * x]) + r0[2 * x + 1] +
                 r1[2 * x] + r1[2 * x + 1];
    }
    ch = nh; cw = nw;
    // further levels in u16
    uint16_t* nxt = scratch.data() + scratch.size() / 2;
    for (int l = 1; l < levels; ++l) {
      nh = ch / 2; nw = cw / 2;
      for (size_t y = 0; y < nh; ++y) {
        const uint16_t* r0 = cur + (2 * y) * cw;
        const uint16_t* r1 = cur + (2 * y + 1) * cw;
        uint16_t* dst = nxt + y * nw;
        for (size_t x = 0; x < nw; ++x)
          dst[x] = static_cast<uint16_t>(r0[2 * x] + r0[2 * x + 1] +
                                         r1[2 * x] + r1[2 * x + 1]);
      }
      std::swap(cur, nxt);
      ch = nh; cw = nw;
    }
    std::memcpy(i_out + t * ho * wo, cur, ho * wo * sizeof(uint16_t));
    // depth: iterated stride-2 subsample == single stride-2^levels pick of
    // the floor-halved grids (dims here are exactly divisible per level)
    const uint16_t* dsrc = du16 + t * h * w;
    size_t stride = static_cast<size_t>(1) << levels;
    uint16_t* ddst = d_out + t * ho * wo;
    for (size_t y = 0; y < ho; ++y) {
      const uint16_t* row = dsrc + (y * stride) * w;
      for (size_t x = 0; x < wo; ++x) ddst[y * wo + x] = row[x * stride];
    }
  }
}

PyObject* py_reduce_ingest(PyObject*, PyObject* args) {
  Py_buffer ibuf, dbuf;
  unsigned long t, h, w;
  int levels;
  if (!PyArg_ParseTuple(args, "y*y*kkki", &ibuf, &dbuf, &t, &h, &w, &levels))
    return nullptr;
  size_t ho = h, wo = w;
  for (int l = 0; l < levels; ++l) { ho /= 2; wo /= 2; }
  bool ok = levels >= 1 && levels <= 3 &&
            ibuf.len == static_cast<Py_ssize_t>(t * h * w) &&
            dbuf.len == static_cast<Py_ssize_t>(t * h * w * 2) &&
            // iterated floor-halving must match the single-stride pick
            (h >> levels) << levels == (ho << levels) &&
            (w >> levels) << levels == (wo << levels);
  // dims with odd intermediate sizes fall back to the Python path
  for (int l = 0, hh = static_cast<int>(h), ww = static_cast<int>(w);
       l < levels; ++l, hh /= 2, ww /= 2)
    if ((hh & 1) || (ww & 1)) ok = false;
  if (!ok) {
    PyBuffer_Release(&ibuf);
    PyBuffer_Release(&dbuf);
    PyErr_SetString(PyExc_ValueError, "reduce_ingest: unsupported shape/levels");
    return nullptr;
  }
  std::vector<uint16_t> i_out(t * ho * wo), d_out(t * ho * wo);
  Py_BEGIN_ALLOW_THREADS {
    const uint8_t* iu8 = static_cast<const uint8_t*>(ibuf.buf);
    const uint16_t* du16 = static_cast<const uint16_t*>(dbuf.buf);
    size_t mid = t / 2;
    std::vector<uint16_t> s1((h / 2) * (w / 2) * 2), s2((h / 2) * (w / 2) * 2);
    std::thread worker([&] {
      reduce_frames(iu8, du16, 0, mid, h, w, levels, i_out.data(),
                    d_out.data(), ho, wo, s1);
    });
    reduce_frames(iu8, du16, mid, t, h, w, levels, i_out.data(), d_out.data(),
                  ho, wo, s2);
    worker.join();
  }
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&ibuf);
  PyBuffer_Release(&dbuf);
  PyObject* ib = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(i_out.data()),
      static_cast<Py_ssize_t>(i_out.size() * 2));
  PyObject* db = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(d_out.data()),
      static_cast<Py_ssize_t>(d_out.size() * 2));
  if (!ib || !db) return nullptr;
  return Py_BuildValue("(NNkk)", ib, db, static_cast<unsigned long>(ho),
                       static_cast<unsigned long>(wo));
}

PyMethodDef methods[] = {
    {"decode_gray_u8", py_decode_gray, METH_VARARGS,
     "Decode PNG bytes to (u8 luma bytes, h, w)."},
    {"decode_depth_u16", py_decode_depth, METH_VARARGS,
     "Decode 16-bit PNG bytes to (u16 bytes, h, w)."},
    {"reduce_ingest", py_reduce_ingest, METH_VARARGS,
     "Reduce [T,H,W] u8 intensity + u16 depth to level L (u16 sums, "
     "subsampled depth)."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module = {PyModuleDef_HEAD_INIT, "_dvo_ingest",
                      "Native RGB-D PNG ingest", -1, methods};

}  // namespace

PyMODINIT_FUNC PyInit__dvo_ingest(void) { return PyModule_Create(&module); }
