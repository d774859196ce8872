// PNG scanline unfilter (the port's own codec, utils/png.py): undoes the five
// row filters of the PNG specification (section 9) in place of libpng's
// png_read_row. Each row is one filter-type byte followed by `rowbytes`
// filtered bytes; Sub, Average and Paeth read the byte `bpp` to the left in
// the same row, so a row is unfiltered serially, byte by byte.
//
// Plain C interface, built by the host compiler and loaded with ctypes.

#include <cstdint>
#include <cstdlib>

extern "C" int png_unfilter(const uint8_t* in, uint8_t* out, int H, long rowbytes, int bpp) {
  const uint8_t* prev = nullptr;  // the unfiltered row above, or none
  for (int y = 0; y < H; ++y) {
    const uint8_t* src = in + static_cast<long>(y) * (rowbytes + 1);
    uint8_t* cur = out + static_cast<long>(y) * rowbytes;
    const int type = src[0];
    ++src;
    switch (type) {
      case 0:  // None
        for (long i = 0; i < rowbytes; ++i) cur[i] = src[i];
        break;
      case 1:  // Sub
        for (long i = 0; i < rowbytes; ++i) cur[i] = static_cast<uint8_t>(src[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:  // Up
        for (long i = 0; i < rowbytes; ++i) cur[i] = static_cast<uint8_t>(src[i] + (prev ? prev[i] : 0));
        break;
      case 3:  // Average
        for (long i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          cur[i] = static_cast<uint8_t>(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:  // Paeth
        for (long i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[i] = static_cast<uint8_t>(src[i] + pred);
        }
        break;
      default:
        return y + 1;  // the 1-based row whose filter type is unknown
    }
    prev = cur;
  }
  return 0;
}
