// Native RGB-D ingest: PNG unfilter + grayscale/depth conversion, and the
// host-side ingest reduction (the port's copy of
// dvo_slam_tpu/native/ingest.cpp, without libpng).
//
// The reference's host-side frame loading uses OpenCV in C++
// (dvo_benchmark/src/benchmark_slam.cpp:46-93: imread, BGR->gray float,
// u16 depth; dvo_core surface_pyramid.cpp:45-105 raw-depth conversion).
// Python orchestrates; this extension does the byte work with the GIL
// released so a thread-pool prefetcher overlaps dataset IO with device
// compute.
//
// PNG decoding is split in two: __init__.py parses the chunks, checks the
// CRCs and inflates the IDAT stream with the standard library's zlib (which
// releases the GIL); this file undoes the scanline filters (None, Sub, Up,
// Average, Paeth) and Adam7 interlacing and converts, giving the bytes the
// reference's libpng transforms give (ingest.cpp:84-150 there): palette
// expanded, gray 1/2/4 bits scaled to 8, alpha and tRNS dropped for luma,
// 16-bit samples cut to their high byte for luma (png_set_strip_16).
//
// Exposes:
//   unfilter_gray_u8(inflated, w, h, bit_depth, color_type, interlace, plte)
//       -> (bytes HxW u8, h, w): 8-bit luma with OpenCV's fixed-point BT.601
//       weights, (4899 R + 9617 G + 1868 B + 8192) >> 14, as
//       cv::cvtColor BGR2GRAY.
//   unfilter_depth_u16(inflated, w, h, bit_depth, color_type, interlace)
//       -> (bytes HxW u16 native-endian, h, w): 16-bit grayscale only.
//   reduce_ingest(u8 bytes, u16 bytes, t, h, w, levels)
//       -> (u16 intensity sums, u16 subsampled depth, ho, wo)
//
// Built on first use with g++ and the Python headers alone (see
// __init__.py); where the build fails, the callers fall back to cv2 and to
// the NumPy reduction.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// A pass of the image: the whole image, or one of Adam7's seven.
struct Pass {
  size_t x0, y0, dx, dy;
};

const Pass kWhole[1] = {{0, 0, 1, 1}};
const Pass kAdam7[7] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                        {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};

size_t channels_of(int color_type) {
  switch (color_type) {
    case 0: return 1;  // gray
    case 2: return 3;  // RGB
    case 3: return 1;  // palette index
    case 4: return 2;  // gray + alpha
    case 6: return 4;  // RGBA
  }
  return 0;
}

inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  return static_cast<uint8_t>(pb <= pc ? b : c);
}

// Undo one scanline's filter in place; prior is the previous unfiltered
// line of the same pass (nullptr on its first line).
bool unfilter_row(int filter, uint8_t* row, const uint8_t* prior, size_t n,
                  size_t bpp) {
  switch (filter) {
    case 0:
      return true;
    case 1:
      for (size_t i = bpp; i < n; ++i) row[i] = static_cast<uint8_t>(row[i] + row[i - bpp]);
      return true;
    case 2:
      if (prior)
        for (size_t i = 0; i < n; ++i) row[i] = static_cast<uint8_t>(row[i] + prior[i]);
      return true;
    case 3:
      for (size_t i = 0; i < n; ++i) {
        unsigned a = i >= bpp ? row[i - bpp] : 0, b = prior ? prior[i] : 0;
        row[i] = static_cast<uint8_t>(row[i] + ((a + b) >> 1));
      }
      return true;
    case 4:
      for (size_t i = 0; i < n; ++i) {
        int a = i >= bpp ? row[i - bpp] : 0, b = prior ? prior[i] : 0;
        int c = (prior && i >= bpp) ? prior[i - bpp] : 0;
        row[i] = static_cast<uint8_t>(row[i] + paeth(a, b, c));
      }
      return true;
  }
  return false;
}

// Sample c of pixel x of an unfiltered line.
inline unsigned sample(const uint8_t* row, size_t x, size_t c, size_t ch, int bit_depth) {
  if (bit_depth == 8) return row[x * ch + c];
  if (bit_depth == 16) {
    const uint8_t* p = row + 2 * (x * ch + c);
    return (static_cast<unsigned>(p[0]) << 8) | p[1];
  }
  // 1, 2 or 4 bits, one channel, most significant bits first
  size_t bit = x * bit_depth;
  unsigned shift = 8 - bit_depth - static_cast<unsigned>(bit & 7);
  return (row[bit >> 3] >> shift) & ((1u << bit_depth) - 1);
}

inline uint8_t luma(unsigned r, unsigned g, unsigned b) {
  return static_cast<uint8_t>((4899u * r + 9617u * g + 1868u * b + 8192u) >> 14);
}

struct DecodeResult {
  std::vector<unsigned char> pixels;
  bool ok = false;
  std::string error;
};

// Unfilter the inflated stream pass by pass and scatter each pixel's
// converted value into the w x h output.
DecodeResult decode(const uint8_t* data, size_t size, size_t w, size_t h,
                    int bit_depth, int color_type, int interlace,
                    const uint8_t* plte, size_t plte_size, bool want_depth) {
  DecodeResult result;
  size_t ch = channels_of(color_type);
  size_t bits = ch * static_cast<size_t>(bit_depth);
  size_t bpp = bits >= 8 ? bits / 8 : 1;
  const Pass* passes = interlace ? kAdam7 : kWhole;
  size_t n_passes = interlace ? 7 : 1;
  // the palette as libpng holds it: 256 entries, zero past the chunk's
  uint8_t palette[256 * 3] = {0};
  std::memcpy(palette, plte, plte_size < sizeof(palette) ? plte_size : sizeof(palette));

  size_t pw[7], ph[7], needed = 0;
  for (size_t p = 0; p < n_passes; ++p) {
    const Pass& ps = passes[p];
    pw[p] = w > ps.x0 ? (w - ps.x0 + ps.dx - 1) / ps.dx : 0;
    ph[p] = h > ps.y0 ? (h - ps.y0 + ps.dy - 1) / ps.dy : 0;
    if (pw[p] && ph[p]) needed += ph[p] * ((pw[p] * bits + 7) / 8 + 1);
  }
  // checked before any allocation: the output is then bounded by the input
  if (size < needed) {
    result.error = "not enough image data";
    return result;
  }
  result.pixels.resize(w * h * (want_depth ? 2 : 1));
  uint8_t* gray = result.pixels.data();
  uint16_t* depth = reinterpret_cast<uint16_t*>(result.pixels.data());
  std::vector<uint8_t> lines;
  size_t offset = 0;
  for (size_t p = 0; p < n_passes; ++p) {
    const Pass& ps = passes[p];
    if (pw[p] == 0 || ph[p] == 0) continue;
    size_t rowbytes = (pw[p] * bits + 7) / 8;
    lines.assign(ph[p] * rowbytes, 0);
    for (size_t y = 0; y < ph[p]; ++y) {
      const uint8_t* src = data + offset + y * (rowbytes + 1);
      uint8_t* row = lines.data() + y * rowbytes;
      std::memcpy(row, src + 1, rowbytes);
      if (!unfilter_row(src[0], row, y ? row - rowbytes : nullptr, rowbytes, bpp)) {
        result.error = "bad adaptive filter value";
        return result;
      }
    }
    offset += ph[p] * (rowbytes + 1);
    for (size_t y = 0; y < ph[p]; ++y) {
      const uint8_t* row = lines.data() + y * rowbytes;
      size_t base = (ps.y0 + y * ps.dy) * w + ps.x0;
      if (want_depth) {  // 16-bit gray, checked by the caller
        for (size_t x = 0; x < pw[p]; ++x)
          depth[base + x * ps.dx] = static_cast<uint16_t>(sample(row, x, 0, 1, 16));
        continue;
      }
      unsigned shift = bit_depth == 16 ? 8 : 0;
      for (size_t x = 0; x < pw[p]; ++x) {
        uint8_t v;
        if (color_type == 0) {
          unsigned s = sample(row, x, 0, 1, bit_depth);
          // png_set_expand_gray_1_2_4_to_8 replicates the bits
          v = static_cast<uint8_t>(bit_depth < 8 ? s * (255u / ((1u << bit_depth) - 1))
                                                 : s >> shift);
        } else if (color_type == 4) {
          v = static_cast<uint8_t>(sample(row, x, 0, 2, bit_depth) >> shift);
        } else if (color_type == 3) {
          const uint8_t* rgb = palette + 3 * sample(row, x, 0, 1, bit_depth);
          v = luma(rgb[0], rgb[1], rgb[2]);
        } else {  // 2 or 6
          v = luma(sample(row, x, 0, ch, bit_depth) >> shift,
                   sample(row, x, 1, ch, bit_depth) >> shift,
                   sample(row, x, 2, ch, bit_depth) >> shift);
        }
        gray[base + x * ps.dx] = v;
      }
    }
  }
  result.ok = true;
  return result;
}

PyObject* decode_common(PyObject* args, bool want_depth) {
  Py_buffer buf, plte{};
  unsigned long w, h;
  int bit_depth, color_type, interlace;
  if (want_depth) {
    if (!PyArg_ParseTuple(args, "y*kkiii", &buf, &w, &h, &bit_depth, &color_type,
                          &interlace))
      return nullptr;
  } else if (!PyArg_ParseTuple(args, "y*kkiiiy*", &buf, &w, &h, &bit_depth,
                               &color_type, &interlace, &plte)) {
    return nullptr;
  }
  size_t ch = channels_of(color_type);
  bool valid = ch != 0 && w > 0 && h > 0 && w <= 1000000 && h <= 1000000 &&
               (bit_depth == 8 || bit_depth == 16 ||
                ((color_type == 0 || color_type == 3) &&
                 (bit_depth == 1 || bit_depth == 2 || bit_depth == 4))) &&
               !(color_type == 3 && bit_depth == 16) && (interlace == 0 || interlace == 1) &&
               (!want_depth || (color_type == 0 && bit_depth == 16));
  DecodeResult result;
  if (valid) {
    Py_BEGIN_ALLOW_THREADS
    result = decode(static_cast<const uint8_t*>(buf.buf), static_cast<size_t>(buf.len), w, h,
                    bit_depth, color_type, interlace,
                    static_cast<const uint8_t*>(plte.buf), static_cast<size_t>(plte.len),
                    want_depth);
    Py_END_ALLOW_THREADS
  } else {
    result.error = want_depth ? "depth PNG is not 16-bit single channel"
                              : "unsupported PNG header";
  }
  PyBuffer_Release(&buf);
  if (!want_depth) PyBuffer_Release(&plte);

  if (!result.ok) {
    PyErr_SetString(PyExc_ValueError, result.error.c_str());
    return nullptr;
  }
  PyObject* bytes = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(result.pixels.data()),
      static_cast<Py_ssize_t>(result.pixels.size()));
  if (!bytes) return nullptr;
  return Py_BuildValue("(Nkk)", bytes, h, w);
}

PyObject* py_unfilter_gray(PyObject*, PyObject* args) {
  return decode_common(args, /*want_depth=*/false);
}

PyObject* py_unfilter_depth(PyObject*, PyObject* args) {
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
    {"unfilter_gray_u8", py_unfilter_gray, METH_VARARGS,
     "Unfilter an inflated PNG stream to (u8 luma bytes, h, w)."},
    {"unfilter_depth_u16", py_unfilter_depth, METH_VARARGS,
     "Unfilter an inflated 16-bit gray PNG stream to (u16 bytes, h, w)."},
    {"reduce_ingest", py_reduce_ingest, METH_VARARGS,
     "Reduce [T,H,W] u8 intensity + u16 depth to level L (u16 sums, "
     "subsampled depth)."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module = {PyModuleDef_HEAD_INIT, "_dvo_ingest",
                      "Native RGB-D PNG ingest", -1, methods};

}  // namespace

PyMODINIT_FUNC PyInit__dvo_ingest(void) { return PyModule_Create(&module); }
