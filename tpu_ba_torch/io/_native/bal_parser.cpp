// Fast BAL problem-file parser (native data-loader component).
//
// The BAL text format (see tpu_ba_torch/io/bal.py) is pure whitespace-
// separated numbers; Python tokenization costs seconds for a file of
// millions of tokens. This parser mmap-reads the file and uses a
// branch-light hand-rolled float scanner. Exposed to Python via ctypes
// (tpu_ba_torch/io/native.py); the Python tokenizer of load_bal is the
// oracle the tests hold it against.
//
// Build (native.py, at first use): g++ -O3 -shared -fPIC bal_parser.cpp -o <lib>.so

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Scanner {
  const char* p;
  const char* end;

  void skip_ws() {
    while (p < end && (*p == ' ' || *p == '\n' || *p == '\r' || *p == '\t')) ++p;
  }

  // strtod is locale-aware and slow; BAL numbers are plain C floats with
  // optional exponent, which this covers exactly.
  double next() {
    skip_ws();
    bool neg = false;
    if (p < end && (*p == '-' || *p == '+')) neg = (*p++ == '-');
    double v = 0.0;
    while (p < end && *p >= '0' && *p <= '9') v = v * 10.0 + (*p++ - '0');
    if (p < end && *p == '.') {
      ++p;
      double scale = 0.1;
      while (p < end && *p >= '0' && *p <= '9') {
        v += (*p++ - '0') * scale;
        scale *= 0.1;
      }
    }
    if (p < end && (*p == 'e' || *p == 'E')) {
      ++p;
      bool eneg = false;
      if (p < end && (*p == '-' || *p == '+')) eneg = (*p++ == '-');
      int ex = 0;
      while (p < end && *p >= '0' && *p <= '9') ex = ex * 10 + (*p++ - '0');
      v *= std::pow(10.0, eneg ? -ex : ex);
    }
    return neg ? -v : v;
  }
};

}  // namespace

extern "C" {

struct BalData {
  int64_t n_cameras;
  int64_t n_points;
  int64_t n_obs;
  int32_t* cam_idx;   // (n_obs)
  int32_t* pt_idx;    // (n_obs)
  double* obs;        // (n_obs, 2)
  double* cameras;    // (n_cameras, 9)
  double* points;     // (n_points, 3)
};

// Returns 0 on success; fills *out (buffers owned by the library — release
// with bal_free).
int bal_parse(const char* path, BalData* out) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return -2; }
  size_t len = static_cast<size_t>(st.st_size);
  const char* data =
      static_cast<const char*>(mmap(nullptr, len, PROT_READ, MAP_PRIVATE, fd, 0));
  close(fd);
  if (data == MAP_FAILED) return -3;

  Scanner s{data, data + len};
  int64_t C = static_cast<int64_t>(s.next());
  int64_t P = static_cast<int64_t>(s.next());
  int64_t O = static_cast<int64_t>(s.next());
  if (C <= 0 || P <= 0 || O <= 0) { munmap(const_cast<char*>(data), len); return -4; }

  out->n_cameras = C;
  out->n_points = P;
  out->n_obs = O;
  out->cam_idx = static_cast<int32_t*>(malloc(sizeof(int32_t) * O));
  out->pt_idx = static_cast<int32_t*>(malloc(sizeof(int32_t) * O));
  out->obs = static_cast<double*>(malloc(sizeof(double) * O * 2));
  out->cameras = static_cast<double*>(malloc(sizeof(double) * C * 9));
  out->points = static_cast<double*>(malloc(sizeof(double) * P * 3));
  if (!out->cam_idx || !out->pt_idx || !out->obs || !out->cameras || !out->points) {
    munmap(const_cast<char*>(data), len);
    return -5;
  }

  for (int64_t i = 0; i < O; ++i) {
    out->cam_idx[i] = static_cast<int32_t>(s.next());
    out->pt_idx[i] = static_cast<int32_t>(s.next());
    out->obs[2 * i] = s.next();
    out->obs[2 * i + 1] = s.next();
  }
  for (int64_t i = 0; i < C * 9; ++i) out->cameras[i] = s.next();
  for (int64_t i = 0; i < P * 3; ++i) out->points[i] = s.next();

  munmap(const_cast<char*>(data), len);
  return 0;
}

void bal_free(BalData* d) {
  free(d->cam_idx);
  free(d->pt_idx);
  free(d->obs);
  free(d->cameras);
  free(d->points);
  memset(d, 0, sizeof(*d));
}

}  // extern "C"
