// Native .bas binary I/O and an asynchronous snapshot writer (the port's
// own copy of msom_tpu/native/basio.cpp).
//
// The reference writes its snapshots in C (gnuplot-format float32
// matrices, msqg/auxiliar_input.h, gathered by MPI_Reduce and written by
// rank 0). This library is the host side of that path: the (de)serialising
// of layer blocks, a background writer thread so that an output event
// need not hold up the step loop, and a batched eigensolver of the
// tridiagonal stretching matrix.
//
// C ABI only, bound from Python with ctypes (msom_tpu_torch/native).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <condition_variable>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// synchronous .bas codec
// ---------------------------------------------------------------------------

// Write nl layer blocks of an (nl, n, n) float32 field stored y-major
// (our convention); the file layout is the reference's x-major transpose:
// per layer: [n][y_0..y_{n-1}] then per row i: [x_i][v(i,0)..v(i,n-1)].
// Returns 0 on success.
int bas_write(const char* path, const float* field, int nl, int n,
              double L0, double x0, double y0) {
  FILE* fp = std::fopen(path, "wb");
  if (!fp) return -1;
  const double delta = L0 / n;
  std::vector<float> row(n + 1);
  std::vector<float> head(n + 1);
  head[0] = (float)n;
  for (int j = 0; j < n; j++) head[j + 1] = (float)(y0 + delta * (j + 0.5));
  for (int l = 0; l < nl; l++) {
    if (std::fwrite(head.data(), sizeof(float), n + 1, fp) != (size_t)(n + 1)) {
      std::fclose(fp);
      return -2;
    }
    const float* lay = field + (size_t)l * n * n;
    for (int i = 0; i < n; i++) {
      row[0] = (float)(x0 + delta * (i + 0.5));
      for (int j = 0; j < n; j++) row[j + 1] = lay[(size_t)j * n + i];
      if (std::fwrite(row.data(), sizeof(float), n + 1, fp) != (size_t)(n + 1)) {
        std::fclose(fp);
        return -2;
      }
    }
  }
  std::fclose(fp);
  return 0;
}

// Read up to max_nl layer blocks into (nl, n, n) y-major float32. Returns
// the number of layers read, or <0 on error. n_out receives the grid size.
int bas_read(const char* path, float* field, int max_nl, int* n_out) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return -1;
  int nl_read = 0;
  int n = 0;
  while (nl_read < max_nl) {
    float fn;
    if (std::fread(&fn, sizeof(float), 1, fp) != 1) break;  // EOF
    n = (int)fn;
    if (n <= 0) { std::fclose(fp); return -3; }
    std::vector<float> buf((size_t)n * (n + 1) + n);
    if (std::fread(buf.data(), sizeof(float), n, fp) != (size_t)n) {
      std::fclose(fp);
      return -2;
    }
    // rows
    float* lay = field + (size_t)nl_read * n * n;
    std::vector<float> row(n + 1);
    for (int i = 0; i < n; i++) {
      if (std::fread(row.data(), sizeof(float), n + 1, fp) != (size_t)(n + 1)) {
        std::fclose(fp);
        return -2;
      }
      for (int j = 0; j < n; j++) lay[(size_t)j * n + i] = row[j + 1];
    }
    nl_read++;
  }
  std::fclose(fp);
  *n_out = n;
  return nl_read;
}

// ---------------------------------------------------------------------------
// asynchronous writer: a background thread drains a job queue
// ---------------------------------------------------------------------------

namespace {

struct Job {
  std::string path;
  std::vector<float> data;
  int nl, n;
  double L0, x0, y0;
};

struct Writer {
  std::deque<Job> queue;
  std::mutex mu;
  std::condition_variable cv;
  std::thread worker;
  bool stop = false;
  int errors = 0;

  void run() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] { return stop || !queue.empty(); });
        if (queue.empty()) {
          if (stop) return;
          continue;
        }
        job = std::move(queue.front());
        queue.pop_front();
      }
      if (bas_write(job.path.c_str(), job.data.data(), job.nl, job.n,
                    job.L0, job.x0, job.y0) != 0) {
        std::lock_guard<std::mutex> lk(mu);
        errors++;
      }
      cv.notify_all();
    }
  }
};

}  // namespace

void* bas_writer_create() {
  Writer* w = new Writer();
  w->worker = std::thread([w] { w->run(); });
  return w;
}

// Enqueue a snapshot (copies the buffer; returns queue depth).
int bas_writer_submit(void* handle, const char* path, const float* field,
                      int nl, int n, double L0, double x0, double y0) {
  Writer* w = (Writer*)handle;
  Job job;
  job.path = path;
  job.data.assign(field, field + (size_t)nl * n * n);
  job.nl = nl;
  job.n = n;
  job.L0 = L0;
  job.x0 = x0;
  job.y0 = y0;
  int depth;
  {
    std::lock_guard<std::mutex> lk(w->mu);
    w->queue.push_back(std::move(job));
    depth = (int)w->queue.size();
  }
  w->cv.notify_all();
  return depth;
}

// Block until the queue is drained; returns accumulated error count.
int bas_writer_flush(void* handle) {
  Writer* w = (Writer*)handle;
  std::unique_lock<std::mutex> lk(w->mu);
  w->cv.wait(lk, [&] { return w->queue.empty(); });
  return w->errors;
}

void bas_writer_destroy(void* handle) {
  Writer* w = (Writer*)handle;
  {
    std::lock_guard<std::mutex> lk(w->mu);
    w->stop = true;
  }
  w->cv.notify_all();
  w->worker.join();
  delete w;
}

// ---------------------------------------------------------------------------
// batched tridiagonal (stretching-matrix) eigensolver
// ---------------------------------------------------------------------------

// The stretching matrix A (eigmode.h:86-106) is unsymmetric tridiagonal with
// sub*super > 0, hence similar to a symmetric tridiagonal via a diagonal
// scaling; we run the implicit-shift QL iteration on the symmetrized form
// and un-scale the eigenvectors. One call handles a batch of columns
// (OpenMP across the batch) — the native replacement for per-cell LAPACK
// dgeev.
//
// lower[b*(nl)+l] (l>=1), diag[b*nl+l], upper[b*nl+l] (l<nl-1);
// out: eigenvalues w[b*nl+m] ascending, right vectors vr[b*nl*nl + l*nl + m].
static int tql2(int n, double* d, double* e, double* z) {
  // symmetric tridiagonal QL with implicit shifts; z (n x n) accumulates
  // the orthogonal transform (starts as identity). Classic algorithm
  // (Golub & Van Loan); returns 0 on success.
  for (int i = 1; i < n; i++) e[i - 1] = e[i];
  e[n - 1] = 0.0;
  for (int l = 0; l < n; l++) {
    int iter = 0;
    int m;
    do {
      for (m = l; m < n - 1; m++) {
        double dd = std::abs(d[m]) + std::abs(d[m + 1]);
        if (std::abs(e[m]) <= 1e-300 + 1e-15 * dd) break;
      }
      if (m != l) {
        if (iter++ == 50) return -1;
        double g = (d[l + 1] - d[l]) / (2.0 * e[l]);
        double r = std::hypot(g, 1.0);
        g = d[m] - d[l] + e[l] / (g + (g >= 0 ? std::abs(r) : -std::abs(r)));
        double s = 1.0, c = 1.0, p = 0.0;
        for (int i = m - 1; i >= l; i--) {
          double f = s * e[i], b = c * e[i];
          r = std::hypot(f, g);
          e[i + 1] = r;
          if (r == 0.0) {
            d[i + 1] -= p;
            e[m] = 0.0;
            break;
          }
          s = f / r;
          c = g / r;
          g = d[i + 1] - p;
          r = (d[i] - g) * s + 2.0 * c * b;
          p = s * r;
          d[i + 1] = g + p;
          g = c * r - b;
          for (int k = 0; k < n; k++) {
            f = z[k * n + i + 1];
            z[k * n + i + 1] = s * z[k * n + i] + c * f;
            z[k * n + i] = c * z[k * n + i] - s * f;
          }
        }
        if (r == 0.0 && m - 1 >= l) continue;
        d[l] -= p;
        e[l] = g;
        e[m] = 0.0;
      }
    } while (m != l);
  }
  return 0;
}

int eig_tridiag_batch(const double* lower, const double* diag,
                      const double* upper, int nl, int nbatch,
                      double* w, double* vr) {
  int status = 0;
#pragma omp parallel for
  for (int b = 0; b < nbatch; b++) {
    std::vector<double> d(nl), e(nl, 0.0), scale(nl, 1.0);
    std::vector<double> z((size_t)nl * nl, 0.0);
    const double* lo = lower + (size_t)b * nl;
    const double* di = diag + (size_t)b * nl;
    const double* up = upper + (size_t)b * nl;
    for (int l = 0; l < nl; l++) {
      d[l] = di[l];
      z[(size_t)l * nl + l] = 1.0;
    }
    // diagonal similarity: D^-1 A D symmetric with offdiag sqrt(lo*up)
    bool ok = true;
    for (int l = 1; l < nl; l++) {
      double prod = lo[l] * up[l - 1];
      if (prod < 0) { ok = false; break; }
      e[l] = std::sqrt(prod);
      scale[l] = (up[l - 1] != 0.0) ? scale[l - 1] * e[l] / up[l - 1]
                                    : scale[l - 1];
    }
    if (!ok || tql2(nl, d.data(), e.data(), z.data()) != 0) {
#pragma omp critical
      status = -1;
      continue;
    }
    // ascending insertion sort of eigenpairs
    std::vector<int> idx(nl);
    for (int i = 0; i < nl; i++) idx[i] = i;
    for (int i = 1; i < nl; i++)
      for (int j = i; j > 0 && d[idx[j]] < d[idx[j - 1]]; j--)
        std::swap(idx[j], idx[j - 1]);
    double* wb = w + (size_t)b * nl;
    double* vb = vr + (size_t)b * nl * nl;
    for (int m = 0; m < nl; m++) {
      wb[m] = d[idx[m]];
      for (int l = 0; l < nl; l++)
        vb[(size_t)l * nl + m] = scale[l] * z[(size_t)l * nl + idx[m]];
    }
  }
  return status;
}

}  // extern "C"
