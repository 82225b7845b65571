// Native batch augmentation: pad-and-crop, horizontal flip, cutout.
//
// The hot loop of the CIFAR input pipeline (the reference delegates this to
// TF's C++ tf.data/image ops; research/improve_nas/trainer/image_processing
// is the Python orchestration). Randomness stays in Python (offsets are
// passed in), so this kernel is a deterministic data-movement transform
// that is exactly testable against the numpy implementation.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libadanet_augment.so augment.cc

#include <cstdint>
#include <cstring>

extern "C" {

// images:  [n, h, w, c] float32 (contiguous)
// out:     [n, h, w, c] float32 (contiguous)
// tops/lefts: per-image crop offsets in [0, 2*pad]
// flips:   per-image 0/1 horizontal flip flags
// cut_ys/cut_xs: per-image cutout centers in [0, h) / [0, w); cutout <= 0
//   disables cutout.
void adanet_augment_apply(const float* images, float* out, int64_t n,
                          int64_t h, int64_t w, int64_t c, int64_t pad,
                          int64_t cutout, const int32_t* tops,
                          const int32_t* lefts, const uint8_t* flips,
                          const int32_t* cut_ys, const int32_t* cut_xs) {
  const int64_t image_size = h * w * c;
  const int64_t row_size = w * c;

  for (int64_t i = 0; i < n; ++i) {
    const float* src = images + i * image_size;
    float* dst = out + i * image_size;
    const int64_t top = tops[i];
    const int64_t left = lefts[i];
    const bool flip = flips[i] != 0;

    // Crop from the zero-padded image: output row y reads padded row
    // (top + y), i.e. source row (top + y - pad); out-of-range rows/cols
    // are zeros.
    for (int64_t y = 0; y < h; ++y) {
      const int64_t src_y = top + y - pad;
      float* dst_row = dst + y * row_size;
      if (src_y < 0 || src_y >= h) {
        std::memset(dst_row, 0, sizeof(float) * row_size);
        continue;
      }
      const float* src_row = src + src_y * row_size;
      for (int64_t x = 0; x < w; ++x) {
        // Flip is applied after the crop, mirroring the numpy path
        // (img = img[:, ::-1] post-crop).
        const int64_t out_x = flip ? (w - 1 - x) : x;
        const int64_t src_x = left + x - pad;
        float* dst_px = dst_row + out_x * c;
        if (src_x < 0 || src_x >= w) {
          std::memset(dst_px, 0, sizeof(float) * c);
        } else {
          std::memcpy(dst_px, src_row + src_x * c, sizeof(float) * c);
        }
      }
    }

    if (cutout > 0) {
      const int64_t cy = cut_ys[i];
      const int64_t cx = cut_xs[i];
      int64_t y0 = cy - cutout / 2, y1 = cy + cutout / 2;
      int64_t x0 = cx - cutout / 2, x1 = cx + cutout / 2;
      if (y0 < 0) y0 = 0;
      if (x0 < 0) x0 = 0;
      if (y1 > h) y1 = h;
      if (x1 > w) x1 = w;
      for (int64_t y = y0; y < y1; ++y) {
        for (int64_t x = x0; x < x1; ++x) {
          std::memset(dst + y * row_size + x * c, 0, sizeof(float) * c);
        }
      }
    }
  }
}

}  // extern "C"
