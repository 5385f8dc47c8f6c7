// PNG scanline unfilter (PNG specification, section 9: filter types 0-4)
// for 8-bit samples, host code with a plain C interface.
//
// `src` holds `height` filtered scanlines of 1 + `stride` bytes each (the
// filter-type byte, then the filtered row), as the inflated IDAT stream of a
// non-interlaced image lays them out; `dst` receives the `height` x `stride`
// reconstructed bytes. `bpp` is the bytes per pixel (the distance back to
// the left neighbour). Returns 0, or 1 + the row index of the first row whose
// filter type is not 0-4.
#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" int p3d_png_unfilter(const uint8_t* src, uint8_t* dst,
                                long long height, long long stride,
                                int bpp) {
  const uint8_t* prev = nullptr;   // the reconstructed row above, or none
  for (long long y = 0; y < height; ++y) {
    const uint8_t* in = src + y * (stride + 1);
    const int type = in[0];
    ++in;
    uint8_t* out = dst + y * stride;
    switch (type) {
      case 0:
        std::memcpy(out, in, stride);
        break;
      case 1:  // Sub: the byte bpp to the left
        for (long long i = 0; i < stride; ++i)
          out[i] = uint8_t(in[i] + (i >= bpp ? out[i - bpp] : 0));
        break;
      case 2:  // Up: the byte above
        if (prev) {
          for (long long i = 0; i < stride; ++i)
            out[i] = uint8_t(in[i] + prev[i]);
        } else {
          std::memcpy(out, in, stride);
        }
        break;
      case 3:  // Average: floor((left + above) / 2)
        for (long long i = 0; i < stride; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          out[i] = uint8_t(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:  // Paeth: the neighbour nearest a + b - c, ties a, b, c
        for (long long i = 0; i < stride; ++i) {
          const int a = i >= bpp ? out[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          out[i] = uint8_t(in[i] + pred);
        }
        break;
      default:
        return int(y) + 1;
    }
    prev = out;
  }
  return 0;
}
