// seed_tpu native data loader.
//
// The reference's input pipeline leans on torchdata's C++ internals and
// per-worker Python processes; the TPU rebuild needs a single host process
// to keep a chip fed (>= thousands of images/sec for the offline
// pre-tokenizer, SURVEY.md §3.5). This library provides the two hot host
// paths as native code behind a minimal C ABI (ctypes-friendly, no
// pybind11):
//
//   1. tar_index / tar_read_batch — mmap-based tar member indexing and
//      zero-copy batched reads (the GIL is released for the whole batch).
//   2. jpeg_decode_resize_batch — libjpeg decode with DCT-domain
//      downscale (scale_num/8) + box resample to the target size, across
//      a std::thread pool.
//
// Build: g++ -O3 -shared -fPIC tarloader.cpp -o libtarloader.so -ljpeg
#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <csetjmp>
#include <jpeglib.h>

extern "C" {

struct TarEntry {
  int64_t offset;   // byte offset of file data within the archive
  int64_t size;     // file size in bytes
  char name[200];
};

// Parse the 512-byte ustar headers of an (uncompressed) tar. Returns the
// number of regular-file entries written, or -1 on error. Tolerates a
// truncated trailer (corrupt-tar tolerance lives in the caller).
int64_t tar_index(const char* path, TarEntry* out, int64_t max_entries) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return -1; }
  int64_t fsize = st.st_size;
  const uint8_t* base =
      (const uint8_t*)mmap(nullptr, fsize, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return -1;

  int64_t pos = 0, count = 0;
  while (pos + 512 <= fsize && count < max_entries) {
    const uint8_t* hdr = base + pos;
    if (hdr[0] == 0) break;  // end-of-archive zero block
    // size field: octal at offset 124, 12 bytes
    char szbuf[13];
    memcpy(szbuf, hdr + 124, 12);
    szbuf[12] = 0;
    int64_t size = strtoll(szbuf, nullptr, 8);
    char type = hdr[156];
    if (type == '0' || type == 0) {  // regular file
      TarEntry& e = out[count++];
      e.offset = pos + 512;
      e.size = size;
      size_t n = strnlen((const char*)hdr, 100);
      size_t cp = std::min(n, sizeof(e.name) - 1);
      memcpy(e.name, hdr, cp);
      e.name[cp] = 0;
    }
    pos += 512 + ((size + 511) / 512) * 512;
  }
  munmap((void*)base, fsize);
  return count;
}

// Read a batch of members into a caller-provided contiguous buffer.
// offsets/sizes are per member; dst must hold sum(sizes).
int tar_read_batch(const char* path, const int64_t* offsets,
                   const int64_t* sizes, int n, uint8_t* dst) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  int64_t out_pos = 0;
  for (int i = 0; i < n; i++) {
    ssize_t got = pread(fd, dst + out_pos, sizes[i], offsets[i]);
    if (got != sizes[i]) { close(fd); return -(i + 2); }
    out_pos += sizes[i];
  }
  close(fd);
  return 0;
}

// ---- JPEG decode + resize --------------------------------------------------

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

static void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = (JpegErr*)cinfo->err;
  longjmp(e->jump, 1);
}

// Decode one JPEG and box-resample to out_h x out_w RGB. Returns 0 on ok.
static int decode_one(const uint8_t* src, int64_t size, int out_h, int out_w,
                      uint8_t* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, src, size);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  cinfo.out_color_space = JCS_RGB;
  // DCT-domain downscale: pick the smallest scale >= target (fast path)
  for (int denom = 8; denom >= 1; denom--) {
    if ((int)cinfo.image_width / denom >= out_w &&
        (int)cinfo.image_height / denom >= out_h) {
      cinfo.scale_num = 1;
      cinfo.scale_denom = denom;
      break;
    }
  }
  jpeg_start_decompress(&cinfo);
  int W = cinfo.output_width, H = cinfo.output_height;
  std::vector<uint8_t> rows((size_t)W * H * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* rowptr = rows.data() + (size_t)cinfo.output_scanline * W * 3;
    jpeg_read_scanlines(&cinfo, &rowptr, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);

  // box resample to (out_h, out_w) with fixed-point accumulation
  for (int y = 0; y < out_h; y++) {
    int y0 = (int)((int64_t)y * H / out_h);
    int y1 = std::max(y0 + 1, (int)((int64_t)(y + 1) * H / out_h));
    for (int x = 0; x < out_w; x++) {
      int x0 = (int)((int64_t)x * W / out_w);
      int x1 = std::max(x0 + 1, (int)((int64_t)(x + 1) * W / out_w));
      int area = (y1 - y0) * (x1 - x0);
      int acc[3] = {0, 0, 0};
      for (int yy = y0; yy < y1; yy++)
        for (int xx = x0; xx < x1; xx++) {
          const uint8_t* p = rows.data() + ((size_t)yy * W + xx) * 3;
          acc[0] += p[0]; acc[1] += p[1]; acc[2] += p[2];
        }
      uint8_t* q = out + ((size_t)y * out_w + x) * 3;
      q[0] = (uint8_t)(acc[0] / area);
      q[1] = (uint8_t)(acc[1] / area);
      q[2] = (uint8_t)(acc[2] / area);
    }
  }
  return 0;
}

// Batch decode across a thread pool. srcs: concatenated jpeg bytes with
// per-item sizes. out: [n, out_h, out_w, 3] uint8. ok: per-item status.
int jpeg_decode_resize_batch(const uint8_t* srcs, const int64_t* sizes, int n,
                             int out_h, int out_w, uint8_t* out, int8_t* ok,
                             int threads) {
  std::vector<int64_t> offsets(n);
  int64_t pos = 0;
  for (int i = 0; i < n; i++) { offsets[i] = pos; pos += sizes[i]; }
  std::atomic<int> next(0);
  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      int rc = decode_one(srcs + offsets[i], sizes[i], out_h, out_w,
                          out + (size_t)i * out_h * out_w * 3);
      ok[i] = (int8_t)(rc == 0 ? 1 : 0);
    }
  };
  int nt = std::max(1, std::min(threads, n));
  std::vector<std::thread> pool;
  for (int t = 0; t < nt; t++) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return 0;
}

}  // extern "C"
