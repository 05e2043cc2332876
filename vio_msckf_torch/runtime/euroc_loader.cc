// Native host-side data runtime: grayscale PNG decode + threaded
// prefetching ring buffer. The port's copy of
// vio_msckf_tpu/runtime/euroc_loader.cc, built by
// vio_msckf_torch/runtime/native_loader.py.
//
// It replaces the reference's Python data layer (MSCKF/dataset.py:
// cv2.imread per frame at dataset.py:110, the dormant prefetch thread at
// dataset.py:106-130, and the DataPublisher replay threads at
// dataset.py:226-271). A worker pool decodes EuRoC's 752x480 grayscale
// PNGs ahead of the consumer and hands frames over through a bounded ring;
// the consumer (the host loop that feeds the GPU) only ever memcpys out of
// the ring into its pinned staging buffer.
//
// Exposed C ABI (consumed via ctypes in runtime/native_loader.py):
//   vio_decode_png_gray(path, out, cap, &w, &h) -> 0/err
//   vio_loader_create(paths, n, w, h, ring, threads) -> handle
//   vio_loader_next(handle, out, &index) -> 0/err   (blocking, in order)
//   vio_loader_destroy(handle)

#include <png.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// PNG decode (grayscale 8-bit output, any libpng-readable input)
// ---------------------------------------------------------------------------

int decode_png_gray(const char* path, uint8_t* out, size_t out_cap,
                    uint32_t* width, uint32_t* height) {
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
  int bit_depth = png_get_bit_depth(png, info);
  int color_type = png_get_color_type(png, info);

  // Normalize everything to 8-bit grayscale.
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  if (color_type == PNG_COLOR_TYPE_RGB ||
      color_type == PNG_COLOR_TYPE_RGB_ALPHA ||
      color_type == PNG_COLOR_TYPE_PALETTE)
    png_set_rgb_to_gray_fixed(png, 1, -1, -1);
  png_read_update_info(png, info);

  if (out_cap < static_cast<size_t>(w) * h) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return -4;
  }

  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; ++y) rows[y] = out + y * w;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(fp);

  *width = w;
  *height = h;
  return 0;
}

// ---------------------------------------------------------------------------
// Prefetching loader: worker pool decodes frames ahead into a bounded ring
// ---------------------------------------------------------------------------

struct Slot {
  std::vector<uint8_t> data;
  int64_t index = -1;
  int status = 1;  // 0 ok, nonzero = decode error
  bool full = false;
};

struct Loader {
  std::vector<std::string> paths;
  uint32_t width = 0, height = 0;
  std::vector<Slot> ring;
  std::vector<std::thread> workers;

  std::mutex mu;
  std::condition_variable cv_space;  // producers wait for their slot
  std::condition_variable cv_data;   // consumer waits for next frame
  std::atomic<int64_t> next_to_decode{0};
  int64_t next_to_consume = 0;
  bool stopping = false;

  size_t frame_bytes() const {
    return static_cast<size_t>(width) * height;
  }

  void worker() {
    std::vector<uint8_t> scratch(frame_bytes());
    for (;;) {
      int64_t idx = next_to_decode.fetch_add(1);
      if (idx >= static_cast<int64_t>(paths.size())) return;

      uint32_t w = 0, h = 0;
      int status = decode_png_gray(paths[idx].c_str(), scratch.data(),
                                   scratch.size(), &w, &h);
      if (status == 0 && (w != width || h != height)) status = -5;

      Slot& slot = ring[idx % ring.size()];
      std::unique_lock<std::mutex> lk(mu);
      // Wait until the consumer has drained the previous occupant AND it is
      // this index's turn for the slot (idx within one ring of the read
      // head) — otherwise a fast worker holding idx+ring could seize the
      // slot first and deadlock the in-order consumer.
      cv_space.wait(lk, [&] {
        return stopping ||
               (!slot.full &&
                idx < next_to_consume + static_cast<int64_t>(ring.size()));
      });
      if (stopping) return;
      slot.data.swap(scratch);
      if (scratch.size() != frame_bytes()) scratch.resize(frame_bytes());
      slot.index = idx;
      slot.status = status;
      slot.full = true;
      cv_data.notify_all();
    }
  }
};

}  // namespace

extern "C" {

int vio_decode_png_gray(const char* path, uint8_t* out, size_t out_cap,
                        uint32_t* width, uint32_t* height) {
  return decode_png_gray(path, out, out_cap, width, height);
}

void* vio_loader_create(const char** paths, int64_t n, uint32_t width,
                        uint32_t height, int32_t ring_capacity,
                        int32_t n_threads) {
  auto* L = new Loader();
  L->paths.assign(paths, paths + n);
  L->width = width;
  L->height = height;
  L->ring.resize(ring_capacity > 1 ? ring_capacity : 2);
  for (auto& s : L->ring) s.data.resize(L->frame_bytes());
  int nt = n_threads > 0 ? n_threads : 2;
  for (int i = 0; i < nt; ++i)
    L->workers.emplace_back([L] { L->worker(); });
  return L;
}

// Blocking: copies the next frame (in sequence order) into `out`.
// Returns 0 on success, the decode error code, or -100 at end of stream.
int vio_loader_next(void* handle, uint8_t* out, int64_t* index) {
  auto* L = static_cast<Loader*>(handle);
  if (L->next_to_consume >= static_cast<int64_t>(L->paths.size()))
    return -100;

  Slot& slot = L->ring[L->next_to_consume % L->ring.size()];
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_data.wait(lk, [&] {
    return slot.full && slot.index == L->next_to_consume;
  });
  std::memcpy(out, slot.data.data(), L->frame_bytes());
  int status = slot.status;
  *index = slot.index;
  slot.full = false;
  L->next_to_consume++;
  L->cv_space.notify_all();
  return status;
}

void vio_loader_destroy(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stopping = true;
  }
  L->next_to_decode.store(static_cast<int64_t>(L->paths.size()));
  L->cv_space.notify_all();
  L->cv_data.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
